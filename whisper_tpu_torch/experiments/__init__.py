"""The port's counterparts of the JAX package's kernel experiments.

Each module runs with ``python -m whisper_tpu_torch.experiments.<name>``,
takes its script's flags and defaults (plus ``--device``, ``cuda`` unless
the caller asks for ``cpu``) and prints each variant's time beside its
bound and its yardstick:

- ``encoder_ops``: K1 at any head dim beside SDPA, the encoder's fc2
  formulations with E1 (``ops.kernels.matmul_residual``), fc1 + GELU;
- ``logits``: the logits projection as ``torch.mm`` and as E2
  (``ops.kernels.logits``) in both weight layouts;
- ``attn_packed``: E3 (``ops.kernels.attn_packed``), two-heads packing
  against two unpacked heads.

No model path calls them.
"""
