"""whisper_tpu_torch's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import).  The file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances, the same as chip_smoke.py's.  K1 f32: max abs error 1e-5 on
outputs of unit scale.  K1 bf16: relative to the plain output, RMS error
5e-3 and max error 1e-2 of max |plain|; on an H100 the kernel reads at most
2.3e-3 and 5.2e-3 at these shapes, while a kernel that stops masking the
keys past T reads an RMS error of 1.45e-2 at T = 1500 and more at shorter
T.  K2: max error relative to max |plain| (f32 1e-4, bf16 2e-2), at one
row, at grouped rows (bf16 above one row on the tensor cores), and at
per-row positions for A audios of G rows (A = B up to 16, 3 x 5 and 16 x 5
= 80 rows).  K2 with int8 weights and/or int8 cross K/V, and K5 (its MLP
stage on its own, bf16/f32 or int8): the same bounds as K2, against their
plain versions on the same int8 values.  K2 with a pending block (W = 8,
0, 3 or 7 columns valid, block starts per row past the cache for some):
K2's bounds.  The int8 logits: max error 1e-5 of max |plain| (both sum
exact products in f32; only the order differs).  K3 and K4 select: their
outputs must equal the plain versions' bit for bit.  A wide decoder's
batch decodes in write blocks, through K2's pending variant, the tokens of
per-step writes.  K1 at head dim 128 takes K1's bounds.  K2 above 128 rows
(launched in slices of whole audios): K2's bounds.  Speculative decoding
with a draft of head dim 64: in f32 the plain greedy decode's tokens and
the CPU's; bf16 and int8 decodes well-formed.  E1 (matmul with the
residual epilogue): f32 max error 1e-4 of max |plain| (f32 sums in another
order over K up to 5120); bf16 per element within
``matmul_residual.bf16_rounding_bound``: the plain version rounds three
times (the product, then after the bias, then after the residual), the
kernel's product summed in another order may round to the neighbour of
the plain one, and each later add may round the two apart by one more
ulp, so ulp(y) + ulp(t) + ulp(out) at the plain values' binades (the next
one up within an ulp of a power of two); on 20 seeds at (24000, 5120,
1280) too.  E2
(streamed logits): max error 1e-5 of max |plain| (exact bf16 products, f32
sums in another order).  E3 (score + PV pairs): max error 8e-3 of max
|plain|, one bf16 ulp of the largest output (a bf16-rounded score may land
one ulp apart and move an output across a rounding boundary), also on
inputs where every rep's feedback moves the queries, so that a kernel
skipping reps disagrees.  K1's and E1's bf16 kernels load by TMA: they refuse a
tensor that does not start on a 16-byte boundary, and K1's last key tile
of a head reads zeros past T, never the next head's rows (NaN values
planted there would make the head's output NaN).
"""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.ops.kernels import attention as k1
from whisper_tpu_torch.ops.kernels import attn_packed as e3
from whisper_tpu_torch.ops.kernels import dtw as k4
from whisper_tpu_torch.ops.kernels import fused_step as k2
from whisper_tpu_torch.ops.kernels import logits as e2
from whisper_tpu_torch.ops.kernels import matmul_residual as e1
from whisper_tpu_torch.ops.kernels import median as k3
from whisper_tpu_torch.ops.kernels import mlp as k5
from whisper_tpu_torch.quantize import Int8Weight, quantize_kv, quantize_weight

pytestmark = pytest.mark.cuda

K1_F32_ATOL = 1e-5
K1_BF16_REL_RMS, K1_BF16_REL_MAX = 5e-3, 1e-2
K2_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOGITS_REL_TOL = 1e-5
E1_F32_REL_TOL = 1e-4
E3_REL_TOL = 8e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape", [(1, 2, 1500, 64), (1, 4, 577, 64), (2, 3, 100, 64), (1, 1, 1, 64),
              (1, 2, 1500, 128), (1, 4, 577, 128), (2, 3, 100, 128), (1, 1, 1, 128),
              (1, 2, 129, 64), (1, 2, 127, 64), (1, 2, 129, 128), (1, 2, 127, 128)]
)
def test_k1_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(3))
    launches = k1.attention.launches
    out = k1.attention(q, k, v)
    assert k1.attention.launches == launches + 1
    ref = k1.attention_plain(q, k, v)
    assert out.dtype == dtype and out.shape == shape
    diff, ref = out.float() - ref.float(), ref.float()
    if dtype == torch.float32:
        assert diff.abs().max().item() <= K1_F32_ATOL
    else:
        assert diff.norm().item() <= K1_BF16_REL_RMS * ref.norm().item()
        assert diff.abs().max().item() <= K1_BF16_REL_MAX * ref.abs().max().item()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [129, 1500])
def test_k1_tail_tile_reads_nothing_of_the_next_head(cuda, d, t):
    """Head 0's last key tile is ragged (T = 129 and 1500 are no multiple
    of 128 keys).  A map that read it from a 2-D view of (B H T, D) would
    load head 1's first rows there.  Their keys are masked, so a key alone
    could not show that read: head 1's first 128 values are NaN, and a
    masked weight of 0 times NaN is NaN in head 0's output.  Head 1's keys
    are 1e3 times larger besides.  Head 0 must be finite and within K1's
    bounds (head 1's own output is NaN and not checked)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((1, 2, t, d), generator=gen, device=cuda) for _ in range(3))
    k[:, 1, :128] *= 1e3
    v[:, 1, :128] = float("nan")
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out, ref = k1.attention(q, k, v)[0, 0].float(), k1.attention_plain(q, k, v)[0, 0].float()
    assert torch.isfinite(out).all()
    diff = out - ref
    assert diff.norm().item() <= K1_BF16_REL_RMS * ref.norm().item()
    assert diff.abs().max().item() <= K1_BF16_REL_MAX * ref.abs().max().item()


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous view of x's values that starts 2 bytes (one bf16) past
    a 16-byte boundary."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = flat.narrow(0, 1, x.numel()).view(x.shape)
    view.copy_(x)
    return view


def test_k1_kernel_refuses_a_misaligned_tensor(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.bfloat16)
    bad = _misaligned(q)
    assert bad.is_contiguous() and bad.data_ptr() % 16 != 0
    for args in ((bad, q, q), (q, bad, q), (q, q, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            k1.attention(*args)


def test_k1_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 2, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        k1.attention(q, q, q)


def _k2_inputs(device, dtype, L=3, C=128, T=64, Ta=1500, B=1, A=1):
    gen = torch.Generator(device=device).manual_seed(0)
    H = C // 64

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    sizes = {"fc1_w": (4 * C, C), "fc2_w": (C, 4 * C), "fc1_b": (4 * C,)}
    blocks = {}
    for n in k2.WEIGHTS:
        shape = (L, *sizes.get(n, (C, C) if n.endswith("_w") else (C,)))
        blocks[n] = (1.0 + randn(*shape, scale=0.1)) if n.endswith("_g") else randn(*shape, scale=0.02)
    # each row its own self cache (distinct histories); cross K/V of A audios
    caches = [randn(L, B, H, 64, T), randn(L, B, H, 64, T), randn(L, A, H, 64, Ta), randn(L, A, H, 64, Ta)]
    return blocks, H, randn(B, C, scale=0.5), caches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [0, 7, 64])
@pytest.mark.parametrize("B", [1, 2, 5, 8, 16])
def test_k2_kernel_matches_plain(cuda, dtype, t, B):
    blocks, H, x, caches = _k2_inputs(cuda, dtype, B=B)
    launches = k2.fused_decoder_layers.launches
    out = k2.fused_decoder_layers(blocks, H, x, t, *caches)
    assert k2.fused_decoder_layers.launches == launches + 1
    ref = k2.fused_decoder_layers_plain(blocks, H, x, t, *caches)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        rel = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
        assert rel <= K2_REL_TOL[dtype]


@pytest.mark.parametrize("B", [3, 4, 8, 16])
def test_k2_kernel_over_input_chunks(cuda, B):
    """At width 1280 the rows' inputs fill the GEMV's shared memory: fc2's
    come in chunks from B = 2 on, and from B = 10 on so do the LayerNorm
    GEMVs', whose statistics then come from device memory first."""
    blocks, H, x, caches = _k2_inputs(cuda, torch.float32, L=1, C=1280, T=16, Ta=64, B=B)
    out = k2.fused_decoder_layers(blocks, H, x, 5, *caches)
    ref = k2.fused_decoder_layers_plain(blocks, H, x, 5, *caches)
    for a, b in zip(out, ref):
        rel = (a - b).abs().max().item() / b.abs().max().item()
        assert rel <= K2_REL_TOL[torch.float32]


@pytest.mark.parametrize("C", [1280, 1536])
@pytest.mark.parametrize("B", [9, 16, 33])
def test_k2_tensor_core_gemv_over_input_chunks(cuda, C, B):
    """bf16 above one row takes the tensor-core GEMV: fc2's input comes in
    chunks of 1280, and at width 1536 so do the LayerNorm GEMVs', whose
    statistics then come from device memory first; 33 rows leave a
    one-row tile."""
    blocks, H, x, caches = _k2_inputs(cuda, torch.bfloat16, L=1, C=C, T=16, Ta=64, B=B)
    out = k2.fused_decoder_layers(blocks, H, x, 5, *caches)
    ref = k2.fused_decoder_layers_plain(blocks, H, x, 5, *caches)
    assert max(_k2_rel_errors(out, ref)) <= K2_REL_TOL[torch.bfloat16]


def test_k2_kernel_one_cross_cache_per_row(cuda):
    """A = B: each row reads its own audio's cross K/V (at one position)."""
    blocks, H, x, caches = _k2_inputs(cuda, torch.float32, B=3, A=3)
    out = k2.fused_decoder_layers(blocks, H, x, 9, *caches)
    ref = k2.fused_decoder_layers_plain(blocks, H, x, 9, *caches)
    for a, b in zip(out, ref):
        rel = (a - b).abs().max().item() / b.abs().max().item()
        assert rel <= K2_REL_TOL[torch.float32]


def _k2_rel_errors(out, ref):
    errs = []
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        errs.append((a.float() - b.float()).abs().max().item() / b.float().abs().max().item())
    return errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,G", [(2, 1), (8, 1), (16, 1), (3, 5), (4, 5), (5, 5), (16, 5)])
def test_k2_kernel_at_per_row_positions_matches_plain(cuda, dtype, A, G):
    """B = A * G rows, each at its own position in [0, T] (T: past the
    cache for some), row b reading audio b // G's cross K/V; the launch is
    counted under its (A, G) layout."""
    B, T = A * G, 64
    blocks, H, x, caches = _k2_inputs(cuda, dtype, T=T, B=B, A=A)
    gen = torch.Generator(device=cuda).manual_seed(B)
    t = torch.randint(0, T + 1, (B,), generator=gen, device=cuda)
    t[0], t[-1] = 0, T
    layout = k2.fused_decoder_layers.launches_by_layout[(A, G)]
    out = k2.fused_decoder_layers(blocks, H, x, t, *caches)
    assert k2.fused_decoder_layers.launches_by_layout[(A, G)] == layout + 1
    ref = k2.fused_decoder_layers_plain(blocks, H, x, t, *caches)
    assert max(_k2_rel_errors(out, ref)) <= K2_REL_TOL[dtype]


def test_k2_kernel_refuses_what_it_does_not_take(cuda):
    blocks, H, x, caches = _k2_inputs(cuda, torch.float32, B=4, A=3)
    with pytest.raises(ValueError, match="audios must divide"):
        k2.fused_decoder_layers(blocks, H, x, 3, *caches)
    blocks, H, x, caches = _k2_inputs(cuda, torch.float32, B=2)
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_decoder_layers(blocks, H, x.to(torch.bfloat16), 3, *caches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,G", [(32, 5), (160, 1), (27, 5), (129, 1)])
def test_k2_kernel_above_128_rows_matches_plain(cuda, dtype, A, G):
    """More than 128 rows at per-row positions launch in slices of whole
    audios (32 x 5: 25 audios, then 7), each counted under its layout."""
    B, T = A * G, 64
    blocks, H, x, caches = _k2_inputs(cuda, dtype, L=2, T=T, B=B, A=A)
    t = torch.randint(0, T + 1, (B,), generator=torch.Generator(device=cuda).manual_seed(B), device=cuda)
    t[0], t[-1] = 0, T
    slices = k2.row_slices(B, A)
    before = dict(k2.fused_decoder_layers.launches_by_layout)
    launches = k2.fused_decoder_layers.launches
    out = k2.fused_decoder_layers(blocks, H, x, t, *caches)
    assert k2.fused_decoder_layers.launches == launches + len(slices) > launches + 1
    for (_, _), (a0, a1) in slices:
        assert k2.fused_decoder_layers.launches_by_layout[(a1 - a0, G)] > before.get((a1 - a0, G), 0)
    ref = k2.fused_decoder_layers_plain(blocks, H, x, t, *caches)
    assert max(_k2_rel_errors(out, ref)) <= K2_REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["", "int8+kv_int8"])
def test_k2_pending_above_128_rows_matches_plain(cuda, dtype, form):
    """A pending block at 32 x 5 rows (two slices), block starts per row."""
    A, G, T, W = 32, 5, 64, 8
    B = A * G
    blocks, H, x, caches = _k2_inputs(cuda, dtype, L=2, T=T, B=B, A=A)
    if form:
        blocks, caches = _int8_form(blocks, caches, form)
    gen = torch.Generator(device=cuda).manual_seed(7)
    pend = [torch.randn((2, B, H, 64, W), generator=gen, device=cuda).to(dtype) for _ in range(2)]
    start = torch.randint(0, T + W, (B,), generator=gen, device=cuda)
    out = k2.fused_decoder_layers(blocks, H, x, start, *caches, *pend, 5)
    ref = k2.fused_decoder_layers_plain(blocks, H, x, start, *caches, *pend, 5)
    assert max(_k2_rel_errors(out, ref)) <= K2_REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,G", [(1, 129), (1, 200), (2, 150)])
@pytest.mark.parametrize("pending", [False, True])
def test_k2_kernel_splits_a_group_wider_than_a_launch(cuda, dtype, A, G, pending):
    """One audio's group of more than 128 rows (best_of 200) launches in
    parts of that audio's group (129: 65 + 64, 200: 100 + 100), each
    reading the audio's cross K/V and its own rows, at per-row positions,
    with and without a pending block: K2's bounds against the plain step."""
    B, T, W = A * G, 64, 8
    blocks, H, x, caches = _k2_inputs(cuda, dtype, L=2, T=T, B=B, A=A)
    gen = torch.Generator(device=cuda).manual_seed(G)
    t = torch.randint(0, T + 1, (B,), generator=gen, device=cuda)
    t[0], t[-1] = 0, T
    pend = ()
    if pending:
        pend = (*(torch.randn((2, B, H, 64, W), generator=gen, device=cuda).to(dtype) for _ in range(2)), 5)
    slices = k2.row_slices(B, A)
    assert len(slices) == A * 2 and all(a1 - a0 == 1 for _, (a0, a1) in slices)
    launches = k2.fused_decoder_layers.launches
    out = k2.fused_decoder_layers(blocks, H, x, t, *caches, *pend)
    assert k2.fused_decoder_layers.launches == launches + len(slices)
    ref = k2.fused_decoder_layers_plain(blocks, H, x, t, *caches, *pend)
    assert max(_k2_rel_errors(out, ref)) <= K2_REL_TOL[dtype]


def test_a_decoder_k2_does_not_take_decodes_on_the_card(cuda):
    """The tests' tiny dims (head dim 32) decode on the card through the
    PyTorch step, chosen by shape before any launch, token for token as on
    the CPU in f32; K2 is not launched."""
    import whisper_tpu_torch
    from whisper_tpu_torch.decoding import DecodingOptions
    from whisper_tpu_torch.models import ModelDimensions
    from whisper_tpu_torch.models.whisper import init_params

    dims = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                           n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_state=64,
                           n_text_head=2, n_text_layer=2)
    params = init_params(dims, torch.Generator().manual_seed(0), torch.float32)
    mel = torch.from_numpy(np.random.RandomState(0).randn(80, 3000).astype(np.float32))

    def to(tree, device):
        return {k: to(v, device) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(device)

    tokens = {}
    launches = k2.fused_decoder_layers.launches
    for device in ("cpu", cuda):
        model = whisper_tpu_torch.Whisper(dims, to(params, device))
        for beam in (None, 5):
            result = model.decode(mel.to(device), DecodingOptions(language="en", temperature=0.0,
                                                                  sample_len=24, beam_size=beam))
            tokens[str(device), beam] = list(result.tokens)
    assert k2.fused_decoder_layers.launches == launches
    for beam in (None, 5):
        assert tokens["cuda", beam] == tokens["cpu", beam] and len(tokens["cpu", beam]) > 0


def _int8_form(blocks, caches, form):
    """blocks and caches with the projections (form "int8"), the cross K/V
    ("kv_int8") or both ("int8+kv_int8") quantized."""
    blocks = dict(blocks)
    if "int8" in form.split("+"):
        for n in k2.PROJECTIONS:
            blocks[n] = quantize_weight(blocks[n])
    if "kv_int8" in form:
        caches = caches[:2] + [quantize_kv(c) for c in caches[2:]]
    return blocks, caches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["int8", "kv_int8", "int8+kv_int8"])
@pytest.mark.parametrize("A,G,per_row", [(1, 1, False), (1, 5, False), (16, 1, True), (3, 5, True),
                                         (5, 5, False), (16, 5, True)])
def test_k2_int8_matches_plain(cuda, dtype, form, A, G, per_row):
    """K2's int8 instances against the plain version on the same int8
    values, counted under their (A, G, form) layout."""
    B, T = A * G, 64
    blocks, H, x, caches = _k2_inputs(cuda, dtype, L=2, T=T, B=B, A=A)
    blocks, caches = _int8_form(blocks, caches, form)
    t = 9
    if per_row:
        t = torch.randint(0, T + 1, (B,), generator=torch.Generator(device=cuda).manual_seed(B),
                          device=cuda)
    key = (A, G, form)
    layout = k2.fused_decoder_layers.launches_by_layout[key]
    out = k2.fused_decoder_layers(blocks, H, x, t, *caches)
    assert k2.fused_decoder_layers.launches_by_layout[key] == layout + 1
    ref = k2.fused_decoder_layers_plain(blocks, H, x, t, *caches)
    assert max(_k2_rel_errors(out, ref)) <= K2_REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 5, 16, 33])
def test_k2_int8_at_width_1280(cuda, dtype, B):
    """int8 weights at turbo's width: fc2's 5120 inputs in chunks, the
    tensor-core GEMV's int8 loads over 1280-wide chunks, 33 rows a ragged
    tile; int8 cross K/V."""
    blocks, H, x, caches = _k2_inputs(cuda, dtype, L=1, C=1280, T=16, Ta=64, B=B)
    blocks, caches = _int8_form(blocks, caches, "int8+kv_int8")
    out = k2.fused_decoder_layers(blocks, H, x, 5, *caches)
    ref = k2.fused_decoder_layers_plain(blocks, H, x, 5, *caches)
    assert max(_k2_rel_errors(out, ref)) <= K2_REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["", "int8+kv_int8"])
@pytest.mark.parametrize("A,G,per_row", [(1, 1, False), (16, 1, True), (3, 5, True), (2, 1, False)])
@pytest.mark.parametrize("pend_w", [0, 3, 7])
def test_k2_pending_matches_plain(cuda, dtype, form, A, G, per_row, pend_w):
    """K2's pending variant: each row attends its cache positions < its
    block start, the first pend_w of its 8 pending columns and its new
    token; counted under its layout with the "pending" tag."""
    B, T, W = A * G, 64, 8
    blocks, H, x, caches = _k2_inputs(cuda, dtype, L=2, T=T, B=B, A=A)
    if form:
        blocks, caches = _int8_form(blocks, caches, form)
    gen = torch.Generator(device=cuda).manual_seed(B + pend_w)
    pend = [torch.randn((2, B, H, 64, W), generator=gen, device=cuda).to(dtype) for _ in range(2)]
    start = 40
    if per_row:  # some blocks start at or past the cache's end
        start = torch.randint(0, T + W, (B,), generator=gen, device=cuda)
        start[0], start[-1] = 0, T + 3
    key = (A, G, "+".join(filter(None, (form, "pending"))))
    layout = k2.fused_decoder_layers.launches_by_layout[key]
    out = k2.fused_decoder_layers(blocks, H, x, start, *caches, *pend, pend_w)
    assert k2.fused_decoder_layers.launches_by_layout[key] == layout + 1
    ref = k2.fused_decoder_layers_plain(blocks, H, x, start, *caches, *pend, pend_w)
    assert max(_k2_rel_errors(out, ref)) <= K2_REL_TOL[dtype]


def test_k2_pending_refuses_a_bad_block(cuda):
    blocks, H, x, caches = _k2_inputs(cuda, torch.float32, L=1, T=8, Ta=16, B=2)
    pk = torch.zeros((1, 2, H, 64, 8), device=cuda)
    for pend in ((pk, pk.to(torch.bfloat16), 1), (pk, pk, 9), (pk[:, :1], pk[:, :1], 0)):
        with pytest.raises(ValueError):
            k2.fused_decoder_layers(blocks, H, x, 3, *caches, *pend)


def test_k2_refuses_a_mixed_int8_form(cuda):
    blocks, H, x, caches = _k2_inputs(cuda, torch.bfloat16, L=1, T=8, Ta=16, B=2)
    blocks["q_w"] = quantize_weight(blocks["q_w"])
    with pytest.raises(ValueError, match="int8, or none"):
        k2.fused_decoder_layers(blocks, H, x, 3, *caches)
    blocks, H, x, caches = _k2_inputs(cuda, torch.bfloat16, L=1, T=8, Ta=16, B=2)
    caches[2] = quantize_kv(caches[2])
    with pytest.raises(ValueError, match="int8, or none"):
        k2.fused_decoder_layers(blocks, H, x, 3, *caches)


def _k5_inputs(cuda, dtype, B, C, int8, seed, bias=True):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(dtype)

    x, g, b = randn(B, C, scale=0.5), 1.0 + randn(C, scale=0.1), randn(C, scale=0.1)
    w1, b1, w2, b2 = randn(4 * C, C, scale=0.05), randn(4 * C, scale=0.1), randn(C, 4 * C, scale=0.05), randn(C, scale=0.1)
    if int8:
        w1, w2 = quantize_weight(w1), quantize_weight(w2)
    return x, g, b, w1, b1 if bias else None, w2, b2 if bias else None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 2, 5, 8, 9, 16, 17, 32, 33, 128])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C", [256, 1280])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("in_place", [False, True])
def test_k5_matches_plain(cuda, dtype, B, int8, C, bias, in_place):
    """bf16: one or two n8 tiles of rows (1-8, 9-16) and row tiles of 16
    above that; in place: out is x, as in K2's MLP stage."""
    x, g, b, w1, b1, w2, b2 = _k5_inputs(cuda, dtype, B, C, int8, B, bias)
    ref = k5.mlp_fused_plain(x, g, b, w1, b1, w2, b2)
    launches = k5.mlp_fused.launches
    out = k5.mlp_fused(x, g, b, w1, b1, w2, b2, out=x if in_place else None)
    assert k5.mlp_fused.launches == launches + 1
    assert (out is x) == in_place
    assert max(_k2_rel_errors([out], [ref])) <= K2_REL_TOL[dtype]


def _nan_padded(t: torch.Tensor, extra: int) -> torch.Tensor:
    """A contiguous view of t's values whose storage goes on for `extra`
    rows of NaN (or, for int8, of 127) past its end."""
    fill = 127 if t.dtype == torch.int8 else float("nan")
    buf = torch.full((t.shape[0] + extra, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    buf[:t.shape[0]] = t
    return buf[:t.shape[0]]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [1, 9, 17])
@pytest.mark.parametrize("C", [272, 1280])
def test_k5_reads_nothing_past_its_ranges(cuda, monkeypatch, int8, B, C):
    """NaN past the ends of what the kernels read: 16 rows past each
    weight (int8: past its scales), 16 rows past x, 4096 values past the
    ff scratch's B * F.  At C = 272 (F = 1088) neither width is a whole
    number of 128-byte chunks, so a block's last weight box and a rank's
    last staged chunk of x or ff reach past the ends of the rows: there the
    kernel must take zeros (TMA's fill, the staging's guard), and a read
    past the last row would bring a NaN into its output (NaN x 0 is NaN).
    The output stays finite and within K2's bounds."""
    x, g, b, w1, b1, w2, b2 = _k5_inputs(cuda, torch.bfloat16, B, C, int8, 3)
    ref = k5.mlp_fused_plain(x, g, b, w1, b1, w2, b2)
    if int8:
        w1, w2 = (Int8Weight(_nan_padded(w.q, 16), _nan_padded(w.s, 16)) for w in (w1, w2))
    else:
        w1, w2 = _nan_padded(w1, 16), _nan_padded(w2, 16)
    x = _nan_padded(x, 16)
    real = k5._ff_scratch
    monkeypatch.setattr(k5, "_ff_scratch", lambda n, F, like: _nan_padded(real(n, F, like)[:, None], 4096)[:, 0])
    out = k5.mlp_fused(x, g, b, w1, b1, w2, b2)
    assert torch.isfinite(out.float()).all()
    assert max(_k2_rel_errors([out], [ref])) <= K2_REL_TOL[torch.bfloat16]


def test_k5_refuses_a_misaligned_weight(cuda):
    for int8 in (False, True):
        x, g, b, w1, b1, w2, b2 = _k5_inputs(cuda, torch.bfloat16, 2, 256, int8, 1)
        bad = Int8Weight(_misaligned(w1.q), w1.s) if int8 else _misaligned(w1)
        assert (bad.q if int8 else bad).data_ptr() % 16 != 0
        with pytest.raises(ValueError, match="16-byte"):
            k5.mlp_fused(x, g, b, bad, b1, w2, b2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [(1,), (5,), (3, 13)])
def test_int8_logits_match_plain(cuda, dtype, rows):
    """The vocabulary (51865) is no multiple of 8: the last block's rows
    past it write nothing."""
    gen = torch.Generator(device=cuda).manual_seed(len(rows))
    emb = torch.randn((51865, 128), generator=gen, device=cuda) * 0.02
    w = quantize_weight(emb)
    hidden = torch.randn((*rows, 128), generator=gen, device=cuda).to(dtype)
    launches = k2.int8_logits.launches
    out = k2.int8_logits(hidden, w)
    assert k2.int8_logits.launches == launches + 1
    ref = k2.int8_logits_plain(hidden, w)
    assert out.shape == ref.shape == (*rows, 51865) and out.dtype == torch.float32
    rel = (out - ref).abs().max().item() / ref.abs().max().item()
    assert rel <= LOGITS_REL_TOL


def _randn(cuda, seed, *shape, scale=1.0, dtype=torch.bfloat16):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=cuda) * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(300, 1024, 256), (24000, 5120, 1280), (1, 32, 8), (129, 96, 136),
                                   (129, 32, 8), (3000, 32, 8)])
def test_e1_kernel_matches_plain(cuda, dtype, M, K, N):
    """Any M (a ragged last row tile), K a multiple of 32 (32: half of the
    bf16 kernel's K step, the rest zeros from TMA), N of 8 (136 and 8:
    ragged column tiles)."""
    x, w = _randn(cuda, 1, M, K, scale=0.3, dtype=dtype), _randn(cuda, 2, K, N, scale=0.02, dtype=dtype)
    bias, res = _randn(cuda, 3, N, scale=0.1, dtype=dtype), _randn(cuda, 4, M, N, scale=0.3, dtype=dtype)
    launches = e1.matmul_residual.launches
    out = e1.matmul_residual(x, w, bias, res)
    assert e1.matmul_residual.launches == launches + 1
    ref = e1.matmul_residual_plain(x, w, bias, res)
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= E1_F32_REL_TOL * ref.float().abs().max().item()
    else:
        assert (diff <= e1.bf16_rounding_bound(x, w, bias, res)).all()


def test_e1_bf16_bound_holds_on_twenty_seeds(cuda):
    """At large-v3's encoder fc2 at batch 16, on 20 draws of inputs: every
    element within the plain version's three roundings."""
    M, K, N = 24000, 5120, 1280
    for seed in range(100, 120):
        x, w = _randn(cuda, seed, M, K, scale=0.3), _randn(cuda, seed + 1000, K, N, scale=0.02)
        bias, res = _randn(cuda, seed + 2000, N, scale=0.1), _randn(cuda, seed + 3000, M, N, scale=0.3)
        diff = (e1.matmul_residual(x, w, bias, res).float() - e1.matmul_residual_plain(x, w, bias, res).float())
        assert (diff.abs() <= e1.bf16_rounding_bound(x, w, bias, res)).all(), seed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_e1_kernel_refuses_a_misaligned_tensor(cuda, dtype):
    x, w = torch.zeros(4, 64, device=cuda, dtype=dtype), torch.zeros(64, 8, device=cuda, dtype=dtype)
    bias, res = torch.zeros(8, device=cuda, dtype=dtype), torch.zeros(4, 8, device=cuda, dtype=dtype)
    args = [x, w, bias, res]
    for i in range(4):
        bad = list(args)
        bad[i] = _misaligned(args[i])
        assert bad[i].is_contiguous() and bad[i].data_ptr() % 16 != 0
        with pytest.raises(ValueError, match="16-byte"):
            e1.matmul_residual(*bad)


def test_e1_kernel_refuses_what_it_does_not_take(cuda):
    x, w = torch.zeros(4, 48, device=cuda), torch.zeros(48, 8, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        e1.matmul_residual(x, w, torch.zeros(8, device=cuda), torch.zeros(4, 8, device=cuda))


@pytest.mark.parametrize("layout", ["vc", "cv"])
@pytest.mark.parametrize("B,V,C", [(1, 51866, 1280), (5, 51866, 1280), (16, 51866, 1280),
                                   (17, 1000, 128), (3, 1001, 64), (16, 1024, 32)])
def test_e2_kernel_matches_plain(cuda, layout, B, V, C):
    """Any V (51866 and 1001: the (C, V) copy's rows not 16-byte aligned;
    1000: not a multiple of the row tiles), more than 16 rows (a second
    row tile)."""
    x, emb = _randn(cuda, 5, B, C), _randn(cuda, 6, V, C, scale=0.02)
    w = emb if layout == "vc" else emb.t().contiguous()
    key = e2.logits_streamed.launches_by_layout[layout]
    out = e2.logits_streamed(x, w, layout)
    assert e2.logits_streamed.launches_by_layout[layout] == key + 1
    ref = e2.logits_streamed_plain(x, w, layout)
    assert out.shape == ref.shape == (B, V) and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= LOGITS_REL_TOL * ref.abs().max().item()


@pytest.mark.parametrize("g,Q,T,reps", [(2, 128, 1536, 2), (3, 32, 96, 3), (1, 80, 40, 1), (2, 64, 64, 0),
                                        (1, 300, 400, 2), (2, 128, 700, 2)])
def test_e3_kernels_match_plain(cuda, g, Q, T, reps):
    """Both variants against their plain versions (Q and T not multiples of
    the kernel's tiles for some; clusters of 4 and 16 blocks, some of
    whose key slices lie past T; Q over 128: chains of 128 rows), and
    packed against unpacked on block-diagonal operands."""
    from whisper_tpu_torch.experiments.attn_packed import block_diagonal

    q2 = _randn(cuda, 7, g, Q, 128, scale=0.1)
    k1, v1, k2_, v2 = (_randn(cuda, 8 + i, g, T, 64, scale=0.1) for i in range(4))
    kp, vp = block_diagonal(k1, k2_), block_diagonal(v1, v2)
    counts = e3.attn_pairs_unpacked.launches, e3.attn_pairs_packed.launches
    unpacked = e3.attn_pairs_unpacked(q2, k1, v1, k2_, v2, reps)
    packed = e3.attn_pairs_packed(q2, kp, vp, reps)
    assert (e3.attn_pairs_unpacked.launches, e3.attn_pairs_packed.launches) == (counts[0] + 1, counts[1] + 1)
    refs = (e3.attn_pairs_unpacked_plain(q2, k1, v1, k2_, v2, reps), e3.attn_pairs_packed_plain(q2, kp, vp, reps))
    for out, ref in zip((unpacked, packed, packed), refs + (unpacked,)):
        assert out.shape == ref.shape == (g, Q, 128) and out.dtype == torch.bfloat16
        scale = max(ref.float().abs().max().item(), 1e-30)
        assert (out.float() - ref.float()).abs().max().item() <= E3_REL_TOL * scale


@pytest.mark.parametrize("Q,T", [(64, 1600), (128, 6144)])
def test_e3_unpacked_kernel_takes_longer_heads(cuda, Q, T):
    """Unpacked heads longer than 4 x 384 keys: clusters of 16 blocks (at
    T = 1600 the last three hold no key)."""
    q2 = _randn(cuda, 7, 1, Q, 128, scale=0.1)
    ks = [_randn(cuda, 8 + i, 1, T, 64, scale=0.1) for i in range(4)]
    out, ref = e3.attn_pairs_unpacked(q2, *ks, 2).float(), e3.attn_pairs_unpacked_plain(q2, *ks, 2).float()
    assert (out - ref).abs().max().item() <= E3_REL_TOL * ref.abs().max().item()


def _hoisted(q2, k1, v1, k2, v2, reps):
    """E3 unpacked as a kernel that hoisted the rep loop would compute it:
    rep 0's o added reps times."""
    o = e3._rep(q2, torch.zeros(q2.shape, device=q2.device), [(slice(0, 64), k1, v1), (slice(64, 128), k2, v2)])
    acc = torch.zeros_like(o)
    for _ in range(reps):
        acc = acc + o
    return acc.to(q2.dtype)


@pytest.mark.parametrize("g,Q,T,reps", [(2, 128, 1536, 8), (3, 80, 96, 5), (1, 200, 1000, 3)])
def test_e3_kernels_match_plain_on_chain_visible_inputs(cuda, g, Q, T, reps):
    """K and V at chain_scale: each rep's feedback moves qq by bf16 ulps, so
    every rep's o differs and a kernel that skipped or hoisted reps fails
    here, not only the smoke's timing guard.  The plain outputs at reps - 1
    and reps, and the hoisted loop's, lie beyond the tolerance."""
    from whisper_tpu_torch.experiments.attn_packed import block_diagonal, chain_scale

    scale = chain_scale(T)
    q2 = _randn(cuda, 7, g, Q, 128, scale=0.1)
    k1, v1, k2_, v2 = (_randn(cuda, 8 + i, g, T, 64, scale=scale) for i in range(4))
    kp, vp = block_diagonal(k1, k2_), block_diagonal(v1, v2)
    ref = e3.attn_pairs_unpacked_plain(q2, k1, v1, k2_, v2, reps).float()
    scale_out = ref.abs().max().item()
    for other in (e3.attn_pairs_unpacked_plain(q2, k1, v1, k2_, v2, reps - 1), _hoisted(q2, k1, v1, k2_, v2, reps)):
        assert (other.float() - ref).abs().max().item() > E3_REL_TOL * scale_out
    outs = (e3.attn_pairs_unpacked(q2, k1, v1, k2_, v2, reps), e3.attn_pairs_packed(q2, kp, vp, reps))
    refs = (ref, e3.attn_pairs_packed_plain(q2, kp, vp, reps).float())
    for out, r in zip(outs, refs):
        assert (out.float() - r).abs().max().item() <= E3_REL_TOL * r.abs().max().item()


def test_e3_kernels_refuse_what_they_do_not_take(cuda):
    """More keys than a cluster of 16 blocks holds, or a misaligned tensor."""
    q2 = torch.zeros(1, 16, 128, device=cuda, dtype=torch.bfloat16)
    long = torch.zeros(1, 6145, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="keys"):
        e3.attn_pairs_unpacked(q2, long, long, long, long, 1)
    kp = torch.zeros(1, 3073, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="keys"):
        e3.attn_pairs_packed(q2, kp, kp, 1)
    kv = torch.zeros(1, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        e3.attn_pairs_unpacked(_misaligned(q2), kv, kv, kv, kv, 1)


@pytest.mark.parametrize("width", [3, 5, 7, 13])
@pytest.mark.parametrize("shape", [(40, 1, 37, 1500), (3, 7), (2, 5, 345)])
def test_k3_kernel_equals_plain(cuda, width, shape):
    gen = torch.Generator(device=cuda).manual_seed(width)
    x = torch.randn(shape, generator=gen, device=cuda)
    x[..., ::11] = 0.0  # ties, and signed zeros
    x[..., 1::13] = -0.0
    launches = k3.median_filter.launches
    out = k3.median_filter(x, width)
    assert k3.median_filter.launches == launches + 1
    ref = k3.median_filter_plain(x, width)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("B,n,m", [(1, 253, 1500), (3, 29, 200), (2, 1, 7), (1, 500, 40)])
@pytest.mark.parametrize("ties", [False, True])
def test_k4_kernel_equals_plain(cuda, B, n, m, ties):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((B, n, m), generator=gen, device=cuda)
    if ties:  # integer costs: many equal branch costs, decided by the tie rule
        x = torch.randint(0, 3, (B, n, m), generator=gen, device=cuda).float()
    launches = k4.dtw_trace.launches
    out = k4.dtw_trace(x, n, m)
    assert k4.dtw_trace.launches == launches + 1
    assert torch.equal(out, k4.dtw_trace_plain(x, n, m))


def _nan_and_zero_ties(x: torch.Tensor) -> torch.Tensor:
    """x with +0 beside -0, NaNs of distinct payloads and both signs, and
    infinities planted along its last axis (bits set through an int32 view)."""
    bits = x.view(torch.int32)
    bits[..., 1::9] = 0
    bits[..., 2::9] = -(2**31)
    bits[..., 5::13] = 0x7FC00001
    bits[..., 6::17] = 0x7F800123
    bits[..., 7::19] = -0x00400001  # 0xFFBFFFFF, a negative NaN
    x[..., 8::23] = float("inf")
    x[..., 3::29] = float("-inf")
    return x


@pytest.mark.parametrize("width", [1, 3, 7, 13])
@pytest.mark.parametrize("shape", [(40, 1, 256, 1500), (7, 1030), (3, 513), (5, 4099), (2, 9)])
@pytest.mark.parametrize("offset", [0, 1])
def test_k3_kernel_keeps_ties_nans_and_ragged_rows(cuda, width, shape, offset):
    """Rows whose length is no multiple of a thread's 4 outputs or of a
    block's 512, rows that start off a 16-byte boundary (offset 1 into the
    allocation), signed zeros and NaN payloads side by side: bit-equal to
    the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(width)
    n = int(np.prod(shape))
    x = torch.randn(n + offset, generator=gen, device=cuda)[offset:].view(shape)
    x[..., ::4] = x[..., ::4].round()
    x = _nan_and_zero_ties(x)
    out = k3.median_filter(x, width)
    ref = k3.median_filter_plain(x, width)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("B,n,m", [(16, 253, 1500), (1, 447, 1500), (1, 1023, 1500), (2, 1023, 37),
                                   (2, 100, 1501), (3, 31, 17), (1, 32, 33), (2, 33, 15), (1, 64, 1)])
@pytest.mark.parametrize("ties", [False, True])
def test_k4_kernel_at_wide_and_ragged_shapes(cuda, B, n, m, ties):
    """The word-timing shape batched, the decoder's 448-token context, the
    largest n it takes (1023: 32 warps), m no multiple of a chunk of
    diagonals, n at warp boundaries: bit-equal to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(n + m)
    x = torch.randn((B, n, m), generator=gen, device=cuda)
    if ties:
        x = torch.randint(0, 3, (B, n, m), generator=gen, device=cuda).float()
    out = k4.dtw_trace(x, n, m)
    assert torch.equal(out, k4.dtw_trace_plain(x, n, m))


def test_k4_kernel_keeps_nan_and_inf_costs(cuda):
    """Costs with NaN and +-inf: every slot's code follows the plain
    version's comparisons (NaN compares false, ties to 2)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 70, 300), generator=gen, device=cuda)
    x[0, 5, 7:40] = float("nan")
    x[1, 20:30, 100] = float("inf")
    x[1, 40, 200:220] = float("-inf")
    assert torch.equal(k4.dtw_trace(x, 70, 300), k4.dtw_trace_plain(x, 70, 300))


def test_k4_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="n <= 1023"):
        k4.dtw_trace(torch.zeros((1, 1024, 8), device=cuda), 1024, 8)
    with pytest.raises(ValueError, match="float32"):
        k4.dtw_trace(torch.zeros((1, 4, 8), device=cuda, dtype=torch.float64), 4, 8)


def test_slice_windows_on_the_card(cuda):
    """The batch path's window slices out of a mel store on the card equal
    their slices on the CPU."""
    from whisper_tpu_torch.batch import _slice_windows

    gen = torch.Generator().manual_seed(0)
    store = torch.randn((3, 128, 7000), generator=gen)
    rows, seeks, sizes = torch.tensor([[0, 2, 1, 2], [0, 123, 6000, 3999], [3000, 2000, 3000, 0]])
    ref = _slice_windows(store, rows, seeks, sizes)
    got = _slice_windows(store.to(cuda), rows.to(cuda), seeks.to(cuda), sizes.to(cuda))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), ref)


def test_greedy_path_runs_both_kernels(cuda):
    import whisper_tpu_torch
    from whisper_tpu_torch.decoding import DecodingOptions
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import init_params

    dims = KNOWN_MODELS["tiny"]
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = whisper_tpu_torch.Whisper(dims, init_params(dims, gen, torch.bfloat16, cuda))
    mel = torch.from_numpy(np.random.RandomState(0).randn(80, 3000).astype(np.float32))
    k1.attention.launches = 0
    k2.fused_decoder_layers.launches = 0
    result = model.decode(mel, DecodingOptions(language=None, sample_len=8))
    assert k1.attention.launches > 0 and k2.fused_decoder_layers.launches > 0
    assert all(0 <= t < model.dims.n_vocab for t in result.tokens)


def test_beam_and_word_timestamp_path_runs_the_kernels(cuda):
    """transcribe with beam 5 and word timestamps on tiny random weights
    launches K2 for groups of 5 rows, K3 and K4."""
    import whisper_tpu_torch
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import init_params

    dims = KNOWN_MODELS["tiny"]
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = whisper_tpu_torch.Whisper(dims, init_params(dims, gen, torch.bfloat16, cuda))
    audio = np.random.RandomState(0).randn(16000 * 4).astype(np.float32) * 0.1
    k2.fused_decoder_layers.launches_by_layout.clear()
    k3.median_filter.launches = 0
    k4.dtw_trace.launches = 0
    result = model.transcribe(audio, language="en", temperature=0.0, beam_size=5, sample_len=16,
                              word_timestamps=True, logprob_threshold=None,
                              compression_ratio_threshold=None, no_speech_threshold=None)
    assert k2.fused_decoder_layers.launches_by_layout[(1, 5)] > 0
    assert k3.median_filter.launches > 0 and k4.dtw_trace.launches > 0
    for segment in result["segments"]:
        for word in segment["words"]:
            assert word["start"] <= word["end"]


def test_int8_path_runs_the_int8_kernels(cuda):
    """A tiny model quantized "int8+logits" decodes with kv_cache_dtype
    "int8" through K2's int8 instances (weights and K/V int8 on the card),
    K5's code and the int8 logits; beam 5 too."""
    import whisper_tpu_torch
    from whisper_tpu_torch.decoding import DecodingOptions
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import init_params
    from whisper_tpu_torch.quantize import quantize_params

    dims = KNOWN_MODELS["tiny"]
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = quantize_params(init_params(dims, gen, torch.bfloat16, cuda), logits=True)
    assert isinstance(params["decoder"]["blocks"]["fc1_w"], Int8Weight)
    assert params["decoder"]["blocks"]["fc1_w"].q.dtype == torch.int8
    model = whisper_tpu_torch.Whisper(dims, params)
    mel = torch.from_numpy(np.random.RandomState(0).randn(80, 3000).astype(np.float32))
    k2.fused_decoder_layers.launches_by_layout.clear()
    k2.int8_logits.launches = k5.mlp_fused.launches = 0
    for beam in (None, 5):
        result = model.decode(mel, DecodingOptions(language="en", sample_len=8, beam_size=beam,
                                                   kv_cache_dtype="int8"))
        assert all(0 <= t < model.dims.n_vocab for t in result.tokens)
    layout = k2.fused_decoder_layers.launches_by_layout
    assert layout[(1, 1, "int8+kv_int8")] > 0 and layout[(1, 5, "int8+kv_int8")] > 0
    assert set(layout) == {(1, 1, "int8+kv_int8"), (1, 5, "int8+kv_int8")}
    assert k2.int8_logits.launches > 0
    assert k5.mlp_fused.launches == dims.n_text_layer * sum(layout.values())


def test_wide_batch_decodes_in_write_blocks(cuda):
    """A decoder 1024 wide: run_with_prompts on three windows (two prompt
    lengths) runs K2's pending variant at (3, 1), and in f32 decodes the
    tokens of per-step writes (log-prob sums within 1e-5)."""
    import whisper_tpu_torch
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_tpu_torch.models import ModelDimensions
    from whisper_tpu_torch.models.whisper import init_params

    dims = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=1024, n_audio_head=16,
                           n_audio_layer=1, n_vocab=51866, n_text_ctx=448, n_text_state=1024,
                           n_text_head=16, n_text_layer=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = whisper_tpu_torch.Whisper(dims, init_params(dims, gen, torch.float32, cuda))
    mels = torch.from_numpy(np.random.RandomState(0).randn(3, 80, 3000).astype(np.float32)).to(cuda)
    task = DecodingTask(model, DecodingOptions(language="en", temperature=0.0, sample_len=21))
    assert task.write_block(3) == 8 and task.write_block(1) == 0
    prompts = [[], [1000] * 5, []]
    k2.fused_decoder_layers.launches_by_layout.clear()
    block = task.run_with_prompts(mels, prompts)
    layout = dict(k2.fused_decoder_layers.launches_by_layout)
    assert set(layout) == {(3, 1, "pending")} and layout[(3, 1, "pending")] % 8 == 0  # whole blocks
    task.write_block = lambda n_audio: 0
    per_step = task.run_with_prompts(mels, prompts)
    for a, b in zip(block, per_step):
        assert a.tokens == b.tokens
        assert abs(a.avg_logprob - b.avg_logprob) <= 1e-5 * max(1.0, abs(b.avg_logprob))


# -- speculative decoding: the draft's steps on K2, the verify pass in torch ---


def _spec_models(device, dtype=torch.float32):
    """A target (two decoder layers of head dim 64) and a draft of one layer
    of head dim 64 that shares its encoder dims: K2 takes both shapes.  The
    weights come from seeded CPU generators, so the CPU holds the same."""
    import whisper_tpu_torch
    from whisper_tpu_torch.models import ModelDimensions
    from whisper_tpu_torch.models.whisper import init_params

    kw = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=1,
              n_vocab=51865, n_text_ctx=448, n_text_state=128, n_text_head=2, n_text_layer=2)
    models = []
    for seed, layers in ((0, 2), (1, 1)):
        dims = ModelDimensions(**dict(kw, n_text_layer=layers))
        params = init_params(dims, torch.Generator().manual_seed(seed), torch.float32)
        models.append(whisper_tpu_torch.Whisper(dims, _to(params, device, dtype)))
    return models


def _to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device, dtype)


@pytest.mark.parametrize("case", ["default", "buffer_cap"])
def test_speculative_on_the_card_equals_greedy_and_the_cpu(cuda, monkeypatch, case):
    """f32, TF32 off: the speculative decode on the card equals the plain
    greedy decode there and the same speculative decode on the CPU, token
    for token; every one-token draft step is a K2 launch, (S - 1) a round
    (the verify pass is torch).  buffer_cap: a 210-token prompt and 220
    tokens to decode run the draft's steps and the verify pass past the
    cache's capacity."""
    from whisper_tpu_torch import engine
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask

    kw = dict(language="en", temperature=0.0, sample_len=24)
    if case == "buffer_cap":
        prompt = [int(x) for x in np.random.RandomState(3).randint(100, 5000, 210)]
        kw.update(sample_len=220, prompt=prompt)
    options = DecodingOptions(**kw)
    mel = torch.from_numpy(np.random.RandomState(0).randn(2, 80, 3000).astype(np.float32) * 0.4)
    real, rounds = engine.decoder_step_k, []

    def counting(params, *args):
        rounds.append(params)
        return real(params, *args)

    monkeypatch.setattr(engine, "decoder_step_k", counting)
    results = {}
    for device in ("cpu", cuda):
        target, draft = _spec_models(device)
        k2.fused_decoder_layers.launches_by_layout.clear()
        k2.fused_decoder_layers.launches = 0
        rounds.clear()
        spec = DecodingTask(target, options, draft_model=draft).run(mel.to(device))
        n_rounds = sum(p is target.params for p in rounds)
        results[torch.device(device).type] = [r.tokens for r in spec]
        if torch.device(device).type == "cuda":
            assert k2.fused_decoder_layers.launches == (options.draft_len - 1) * n_rounds > 0
            assert set(k2.fused_decoder_layers.launches_by_layout) == {(2, 1)}
            plain = DecodingTask(target, options).run(mel.to(device))
            assert [r.tokens for r in plain] == results["cuda"]
    assert results["cuda"] == results["cpu"]


def test_speculative_bf16_and_int8_on_the_card_are_well_formed(cuda):
    """bf16, and the target int8 with int8 cross K/V: the decodes come back
    well-formed, the draft's steps on K2."""
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_tpu_torch.models.whisper import Whisper
    from whisper_tpu_torch.quantize import quantize_params

    target, draft = _spec_models(cuda, torch.bfloat16)
    qtarget = Whisper(target.dims, quantize_params(target.params))
    mel = torch.from_numpy(np.random.RandomState(0).randn(80, 3000).astype(np.float32) * 0.4)
    for model, kv in ((target, None), (qtarget, "int8")):
        k2.fused_decoder_layers.launches = 0
        options = DecodingOptions(language="en", temperature=0.0, sample_len=24, kv_cache_dtype=kv)
        result = DecodingTask(model, options, draft_model=draft).run(mel[None].to(cuda))[0]
        assert 0 < len(result.tokens) and all(0 <= t < model.dims.n_vocab for t in result.tokens)
        assert np.isfinite(result.avg_logprob) and isinstance(result.text, str)
        assert k2.fused_decoder_layers.launches > 0


def test_stage_timer_reads_cuda_events(cuda):
    """On a CUDA device the StageTimer's stages are CUDA events: a stage
    holds the device time of its queued work, read at report()."""
    from whisper_tpu_torch.profiling import StageTimer, device_memory_stats

    timer = StageTimer(cuda)
    a = torch.randn(4096, 4096, device=cuda)
    with timer.stage("matmul"):
        for _ in range(20):
            a = a @ a / 64.0
    with timer.stage("empty"):
        pass
    report = timer.report()
    assert timer.counts["matmul"] == 1 and report["matmul_seconds"] > report["empty_seconds"] >= 0
    assert device_memory_stats(cuda)["allocated_bytes.all.current"] > 0


# -- K2 redesigned: what its tiles may read, and its launch chain -------------


def _nan_tail(x: torch.Tensor, pad: int = 64) -> torch.Tensor:
    """A contiguous copy of x whose allocation continues with NaN (or, for
    an integer tensor, its largest value) past its end: a read past the
    tensor's last row lands there."""
    fill = float("nan") if x.is_floating_point() else torch.iinfo(x.dtype).max
    flat = torch.full((x.numel() + pad,), fill, dtype=x.dtype, device=x.device)
    view = flat[:x.numel()].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["", "int8", "kv_int8", "int8+kv_int8"])
@pytest.mark.parametrize("A,G,per_row", [(1, 1, False), (1, 5, False), (16, 1, True), (3, 5, True)])
@pytest.mark.parametrize("pend_w", [None, 3])
def test_k2_reads_no_key_it_does_not_attend(cuda, dtype, form, A, G, per_row, pend_w):
    """NaN planted where K2 must not read: every self-cache column at or
    past a row's position (the last row at T, its tensor followed by NaN),
    every pending column at or past pend_w (and past the block's end), an
    extra audio's whole cross K/V (and its scales in int8; past the
    tensors' ends too).  A weight of 0 times NaN is NaN, so a tile that
    read any of it into a sum would show.  The first A audios' rows must be
    finite and match the plain version run with the NaN set to 0."""
    B, T, W, L = (A + 1) * G, 64, 8, 2
    blocks, H, x, caches = _k2_inputs(cuda, dtype, L=L, T=T, B=B, A=A + 1)
    gen = torch.Generator(device=cuda).manual_seed(B)
    t = torch.randint(0, T + 1, (B,), generator=gen, device=cuda) if per_row else torch.full((B,), 37, device=cuda)
    t[-1] = T
    cols = torch.arange(T, device=cuda)
    for c in caches[:2]:
        c.masked_fill_(cols >= t[None, :, None, None, None], float("nan"))
    for c in caches[2:]:
        c[:, A:] = float("nan")
    pend = []
    if pend_w is not None:
        pend = [torch.randn((L, B, H, 64, W), generator=gen, device=cuda).to(dtype) for _ in range(2)]
        for p in pend:
            p[..., pend_w:] = float("nan")
    clean = lambda c: torch.nan_to_num(c, nan=0.0)  # noqa: E731
    ref_blocks, ref_caches = _int8_form(blocks, [clean(c) for c in caches], form)
    blocks, caches = _int8_form(blocks, caches, form)
    if "kv_int8" in form:  # the extra audio's scales instead: int8 values hold no NaN
        for c in caches[2:]:
            c.s[:, A:] = float("nan")
        caches = caches[:2] + [Int8Weight(_nan_tail(c.q), _nan_tail(c.s)) for c in caches[2:]]
    else:
        caches = caches[:2] + [_nan_tail(c) for c in caches[2:]]
    caches = [_nan_tail(c) for c in caches[:2]] + caches[2:]
    pos = t if per_row else 37
    args = (pend_w,) if pend_w is not None else ()
    out = k2.fused_decoder_layers(blocks, H, x, pos, *caches, *[_nan_tail(p) for p in pend], *args)
    ref = k2.fused_decoder_layers_plain(ref_blocks, H, x, pos, *ref_caches, *[clean(p) for p in pend], *args)
    rows = A * G
    out = [out[0][:rows], out[1][:, :rows], out[2][:, :rows]]
    ref = [ref[0][:rows], ref[1][:, :rows], ref[2][:, :rows]]
    assert all(torch.isfinite(o).all() for o in out)
    assert max(_k2_rel_errors(out, ref)) <= K2_REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 5, 8])
def test_k2_cross_attention_reads_no_other_head(cuda, dtype, int8, G):
    """K2's cross-attention launch alone at Ta = 1500 (bf16 and int8 rows
    start inside 16-byte chunks): head 1's and audio 1's K/V are NaN (int8:
    their scales), so head 0 of audio 0's rows reads no NaN unless a tile
    ran past its rows; it must be finite and match the plain version."""
    A, H, Ta = 2, 2, 1500
    C = 64 * H
    q = _randn(cuda, 1, A * G, C, dtype=dtype)
    xk, xv = _randn(cuda, 2, A, H, 64, Ta, dtype=dtype), _randn(cuda, 3, A, H, 64, Ta, dtype=dtype)
    if int8:
        xk, xv = quantize_kv(xk), quantize_kv(xv)
        ref = k2.cross_attention_plain(q, xk, xv)
        for c in (xk, xv):
            c.s[:, 1] = float("nan")
            c.s[1] = float("nan")
    else:
        ref = k2.cross_attention_plain(q, xk, xv)
        for c in (xk, xv):
            c[:, 1] = float("nan")
            c[1] = float("nan")
    launches = k2.cross_attention.launches
    out = k2.cross_attention(q, xk, xv)
    assert k2.cross_attention.launches == launches + 1
    got, want = out[:G, :64].float(), ref[:G, :64].float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= K2_REL_TOL[dtype] * want.abs().max().item()


def test_k2_refuses_a_misaligned_cache(cuda):
    blocks, H, x, caches = _k2_inputs(cuda, torch.bfloat16, L=1, T=8, Ta=16, B=1)
    for i in range(4):
        bad = list(caches)
        bad[i] = _misaligned(caches[i])
        with pytest.raises(ValueError, match="16-byte"):
            k2.fused_decoder_layers(blocks, H, x, 3, *bad)


def _turbo_step(cuda, A, G):
    """K2's arguments at large-v3-turbo's decoder widths (L=4, C=1280,
    T=256, Ta=1500), bf16, B = A * G rows at per-row positions."""
    B = A * G
    blocks, H, x, caches = _k2_inputs(cuda, torch.bfloat16, L=4, C=1280, T=256, Ta=1500, B=B, A=A)
    t = torch.randint(0, 257, (B,), generator=torch.Generator(device=cuda).manual_seed(B), device=cuda)
    return blocks, H, x, t, caches


@pytest.mark.parametrize("mode", ["eager", "graph"])
@pytest.mark.parametrize("A,G", [(1, 1), (1, 5), (16, 1)])
def test_k2_back_to_back_steps_are_identical(cuda, mode, A, G):
    """200 steps launched back to back, each launch after a step's first
    overlapping its predecessor (programmatic dependent launch), eagerly
    and replayed from a CUDA graph: a launch that read an input before the
    launch writing it finished would change some step's output.  Every
    output equals the first step's bit for bit, and that one matches the
    plain version."""
    blocks, H, x, t, caches = _turbo_step(cuda, A, G)
    step = lambda: k2.fused_decoder_layers(blocks, H, x, t, *caches)  # noqa: E731
    first = [o.clone() for o in step()]
    ref = k2.fused_decoder_layers_plain(blocks, H, x, t, *caches)
    assert max(_k2_rel_errors(first, ref)) <= K2_REL_TOL[torch.bfloat16]
    if mode == "graph":
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = step()
    outs = []
    for i in range(200):
        if mode == "graph":
            graph.replay()
            outs.append([o.clone() for o in static])
        else:
            outs.append(step())
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert all(torch.equal(a, b) for a, b in zip(out, first)), f"step {i} differs"


@pytest.mark.parametrize("mode", ["eager", "graph"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [1, 5, 9, 16, 17, 128])
def test_k5_back_to_back_calls_are_identical(cuda, mode, int8, B):
    """K5 (fc1, then fc2 under programmatic dependent launch, its weights
    streaming before it waits) 200 times back to back at C = 1280: each
    output equals the first bit for bit."""
    C = 1280
    x, g, b = _randn(cuda, 1, B, C, scale=0.5), 1.0 + _randn(cuda, 2, C, scale=0.1), _randn(cuda, 3, C, scale=0.1)
    w1, b1 = _randn(cuda, 4, 4 * C, C, scale=0.05), _randn(cuda, 5, 4 * C, scale=0.1)
    w2, b2 = _randn(cuda, 6, C, 4 * C, scale=0.05), _randn(cuda, 7, C, scale=0.1)
    if int8:
        w1, w2 = quantize_weight(w1), quantize_weight(w2)
    call = lambda: k5.mlp_fused(x, g, b, w1, b1, w2, b2)  # noqa: E731
    first = call().clone()
    assert max(_k2_rel_errors([first], [k5.mlp_fused_plain(x, g, b, w1, b1, w2, b2)])) <= K2_REL_TOL[torch.bfloat16]
    if mode == "graph":
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = call()
    outs = []
    for _ in range(200):
        if mode == "graph":
            graph.replay()
            outs.append(static.clone())
        else:
            outs.append(call())
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


@pytest.mark.parametrize("layout", ["vc", "cv"])
@pytest.mark.parametrize("B", [1, 5, 8, 16, 17, 40, 70])
@pytest.mark.parametrize("V,C", [(51866, 1280), (1001, 96), (100, 1280)])
def test_e2_persistent_grid_matches_plain(cuda, layout, B, V, C):
    """E2's persistent grid: an odd V (1001: the (C, V) copy's rows on
    2-byte boundaries, plain loads), a V smaller than the grid's blocks
    hold (100 rows: most blocks own nothing), C no multiple of 64 (96: the
    last TMA box is zero-filled past C), and B up to 70 (x rows of 1, 2, 4
    and 8 n8 tiles, or four m16 tiles; 70: a second launch of rows)."""
    x, emb = _randn(cuda, 8, B, C), _randn(cuda, 9, V, C, scale=0.02)
    w = emb if layout == "vc" else emb.t().contiguous()
    out = e2.logits_streamed(x, w, layout)
    ref = e2.logits_streamed_plain(x, w, layout)
    assert out.shape == ref.shape == (B, V)
    assert (out - ref).abs().max().item() <= LOGITS_REL_TOL * ref.abs().max().item()


def test_e2_refuses_a_misaligned_tensor(cuda):
    x, emb = _randn(cuda, 1, 2, 64), _randn(cuda, 2, 100, 64)
    for args in ((_misaligned(x), emb), (x, _misaligned(emb))):
        with pytest.raises(ValueError, match="16-byte"):
            e2.logits_streamed(*args, "vc")
