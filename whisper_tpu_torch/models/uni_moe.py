"""Uni-MoE-2.0-Omni's speech-to-text path (HIT-TMG; ``model_type``
``grin_qwen2_vl``) as functions on tensors: a Whisper-large encoder, a
linear connector to 200 audio tokens a window, and a 28-layer decoder-only
language model whose every MLP is a dynamic-capacity mixture of experts.

The equations, x a row of the residual stream:

- tower: :func:`~.whisper.encoder_apply` over the window's mel (the Whisper
  encoder's kernels where the inputs allow), 1500 x 1280 features;
- connector: ``F.adaptive_avg_pool1d`` over time to ``n_audio_tokens``
  positions (position i averages frames [floor(i T / n), ceil((i + 1) T /
  n))), then a linear layer with bias to the LM's width;
- block: ``h = x + Attn(RMSNorm(x)); x' = h + MoE(RMSNorm(h))``, RMSNorm
  ``w x / sqrt(mean(x^2) + eps)`` in f32, rounded once; Attn is GQA (q, k
  and v with biases, o without; query head j reads K/V head j // (H /
  KVH)) with Qwen2's rotate-half RoPE at positions 0..N-1 of the window's
  sequence (the three ``mrope_section`` parts take the same index for audio
  and text, which is 1-D RoPE), causal over the cache;
- MoE: ``p = softmax(x_f32 W_r)`` over the routed experts and the null
  expert (last), f32; sorted descending, the first ``k = min(top_k, 1 +
  #{j : cumsum_j < top_p})`` are picked; ``MoE(x) = sum over picked
  routed e of p_e E_e(x) + sum over the shared s of S_s(x)``, each a SwiGLU
  ``W_down(silu(W_gate x) * W_up x)``; a picked null expert adds nothing,
  the picks' weights are not renormalised, and no token is dropped;
- head: a final RMSNorm and an untied projection to f32 logits.

The port's parameters (``UniMoe.params``) keep the tower in the Whisper
port's layout (``params["encoder"]``, read by ``encoder_apply``) and the
language model as a list of layers, each with q, k and v in one weight
(``qkv_w``) and every expert, routed and shared, in two: ``experts_gu_w``
stacks the gate rows of the routed experts, then the shared ones', then
their up rows, and ``experts_down_w`` their down projections side by side
along its input.  A step then runs every routed expert over all of its rows
in one product with a routing weight that is 0 where a row did not pick
it (the fixed-shape form: no host sync, the same bytes as a grouped form
once every expert is hit), and the weighted sum of the experts, the shared
ones and the residual in a second product.

:func:`convert_state_dict` builds them from a state_dict of one tensor a
part, consuming it layer by layer so that the model needs its own size and
one layer more.  Its keys (C the LM's width, Ca the tower's, H and KVH the
query and K/V heads of D, E and E0 the routed and null experts, F and Fs
the routed and shared experts' widths, V the vocabulary):

    encoder.*                                  the Whisper encoder, openai/whisper's keys
    connector.weight (C, Ca), .bias (C,)
    embed_tokens.weight (V, C)
    layers.{i}.input_norm.weight (C,)
    layers.{i}.attn.{q,k,v}.weight (H D | KVH D, C), .bias; layers.{i}.attn.o.weight (C, H D)
    layers.{i}.post_norm.weight (C,)
    layers.{i}.moe.router.weight (E + E0, C), float32, the null experts last
    layers.{i}.moe.experts.{e}.{gate,up}.weight (F, C), .down.weight (C, F)
    layers.{i}.moe.shared.{s}.{gate,up}.weight (Fs, C), .down.weight (C, Fs)
    norm.weight (C,)
    lm_head.weight (V, C)
"""

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..profiling import span
from .dims import ModelDimensions
from .load import cast_params, encoder_params
from .whisper import encoder_apply

Params = Dict[str, object]

@dataclass(frozen=True)
class UniMoeDims:
    """The sizes of the speech-to-text path (the catalog's config keys in
    brackets)."""

    n_mels: int  # the tower: Whisper-large-v3's encoder
    n_audio_ctx: int
    n_audio_state: int  # [whisper_hidden_size]
    n_audio_head: int
    n_audio_layer: int
    n_audio_tokens: int  # [whisper_query_tokens_size]
    n_state: int  # [hidden_size]
    n_layer: int  # [num_hidden_layers]
    n_head: int  # [num_attention_heads]
    n_kv_head: int  # [num_key_value_heads]
    n_vocab: int  # [vocab_size]
    n_ctx: int  # positions of one window's cache: prompt, audio and decoded tokens
    n_expert: int  # [mlp_dynamic_expert_num]
    n_null_expert: int  # [mlp_dynamic_null_expert_num]
    expert_width: int  # [dynamic_intermediate_size]
    n_shared: int  # [mlp_fixed_expert_num]
    shared_width: int  # [shared_intermediate_size]
    top_k: int  # [mlp_dynamic_top_k]
    top_p: float  # [mlp_dynamic_top_p]
    rope_theta: float  # [rope_theta]
    rms_eps: float  # [rms_norm_eps]
    eos: int  # <|im_end|>, which ends a window's text

    @property
    def head_dim(self) -> int:
        return self.n_state // self.n_head

    @property
    def tower_dims(self) -> ModelDimensions:
        """The tower's sizes as the Whisper encoder reads them (its text
        fields are the language model's, which ``encoder_apply`` never
        reads)."""
        return ModelDimensions(self.n_mels, self.n_audio_ctx, self.n_audio_state, self.n_audio_head,
                               self.n_audio_layer, self.n_vocab, self.n_ctx, self.n_state, self.n_head,
                               self.n_layer)

    @property
    def routed_width(self) -> int:
        """The columns of the routed experts in the fused expert weights."""
        return self.n_expert * self.expert_width

    @property
    def fused_width(self) -> int:
        """Every expert's intermediate columns, routed then shared."""
        return self.routed_width + self.n_shared * self.shared_width


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def convert_state_dict(state: Dict[str, torch.Tensor], dims: UniMoeDims) -> Params:
    """The port's parameters from a state_dict in the module docstring's
    layout, which is emptied as it goes: each layer's tensors are joined
    into the fused weights and dropped before the next layer, so that the
    whole conversion needs the model's size and one layer more.  The
    weights keep the token embedding's dtype and device; the norms' gains
    and the router are f32."""
    device, dtype = state["embed_tokens.weight"].device, state["embed_tokens.weight"].dtype

    def take(key: str) -> torch.Tensor:
        return state.pop(key).detach()

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype)

    def f32(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=torch.float32)

    encoder = encoder_params({k: state.pop(k) for k in [k for k in state if k.startswith("encoder.")]},
                             dims.tower_dims)
    params: Params = {
        "encoder": cast_params(encoder, dtype, device),
        "connector_w": cast(take("connector.weight")),
        "connector_b": cast(take("connector.bias")),
        "embed": cast(take("embed_tokens.weight")),
        "layers": [],
    }
    for i in range(dims.n_layer):
        pre = f"layers.{i}."
        attn = [take(pre + f"attn.{n}.{w}") for w in ("weight", "bias") for n in "qkv"]
        experts = [f"{pre}moe.experts.{e}" for e in range(dims.n_expert)]
        experts += [f"{pre}moe.shared.{s}" for s in range(dims.n_shared)]
        gate_up = [take(f"{e}.{part}.weight") for part in ("gate", "up") for e in experts]
        down = [take(f"{e}.down.weight") for e in experts]
        params["layers"].append({
            "attn_norm": f32(take(pre + "input_norm.weight")),
            "qkv_w": cast(torch.cat(attn[:3])),
            "qkv_b": cast(torch.cat(attn[3:])),
            "o_w": cast(take(pre + "attn.o.weight")),
            "moe_norm": f32(take(pre + "post_norm.weight")),
            "router_w": f32(take(pre + "moe.router.weight")),
            "experts_gu_w": cast(torch.cat(gate_up)),
            "experts_down_w": cast(torch.cat(down, dim=1)),
        })
        del attn, gate_up, down
    params["norm"] = f32(take("norm.weight"))
    params["head"] = cast(take("lm_head.weight"))
    if state:
        raise ValueError(f"convert_state_dict: keys outside the layout: {sorted(state)[:8]}")
    return params


def rope_tables(dims: UniMoeDims, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (n_ctx, H + 2 KVH, D) of Qwen2's rotate-half RoPE for
    the q, k and v heads of one projection, computed in f64 and rounded to
    ``dtype`` (as Qwen2's rotary embedding casts them); the v heads' rows
    are cos 1 and sin 0, which leave them as they are, and the sin table's
    first half is negated, so that ``x cos + roll(x, D/2) sin`` is ``x cos +
    rotate_half(x) sin``."""
    D, qk = dims.head_dim, dims.n_head + dims.n_kv_head
    inv = 1.0 / dims.rope_theta ** (torch.arange(0, D, 2, dtype=torch.float64, device=device) / D)
    angles = torch.arange(dims.n_ctx, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    angles = torch.cat([angles, angles], dim=-1)[:, None, :].expand(-1, qk + dims.n_kv_head, -1).clone()
    angles[:, qk:] = 0
    sin = angles.sin()
    sin[..., : D // 2] *= -1
    return angles.cos().to(dtype), sin.to(dtype)


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``w x / sqrt(mean(x^2) + eps)`` in f32 (w f32), rounded once to x's
    dtype."""
    return F.rms_norm(x.float(), x.shape[-1:], w, eps).to(x.dtype)


def _qkv(x: torch.Tensor, p: Params, dims: UniMoeDims, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """q, k and v of rows x (..., C) in one product, as (..., H + 2 KVH, D),
    q and k rotated by the RoPE tables' rows cos, sin (broadcast over x's
    rows)."""
    qkv = F.linear(rms_norm(x, p["attn_norm"], dims.rms_eps), p["qkv_w"], p["qkv_b"])
    qkv = qkv.unflatten(-1, (dims.n_head + 2 * dims.n_kv_head, dims.head_dim))
    return torch.addcmul(qkv * cos, qkv.roll(dims.head_dim // 2, -1), sin)


def route(h: torch.Tensor, router_w: torch.Tensor, top_p: float, top_k: int) -> torch.Tensor:
    """The routing weights (N, E + E0) f32 of h (N, C): each row's softmax
    over its router logits (f32), kept at the picks and 0 elsewhere.  The
    picks are the first ``min(top_k, 1 + #{j : cumsum_j < top_p})`` of the
    sorted probabilities: pick j is kept while the mass before it is under
    top_p.  A kept weight is never 0 (a softmax of finite logits), so the
    picks are the weights above 0."""
    p = torch.softmax(F.linear(h.float(), router_w), dim=-1)
    top, idx = p.topk(top_k, dim=-1)
    keep = (top.cumsum(-1) - top) < top_p
    return torch.zeros_like(p).scatter_(-1, idx, top * keep)


def weigh_experts(act: torch.Tensor, weights: torch.Tensor, dims: UniMoeDims) -> torch.Tensor:
    """Every expert's activations (N, fused_width), the routed experts'
    columns scaled in place by their routing weights (0 where a row did not
    pick the expert), the shared experts' left as they are."""
    n = act.shape[0]
    act[:, : dims.routed_width].view(n, dims.n_expert, dims.expert_width).mul_(
        weights[:, : dims.n_expert, None])
    return act


def moe(h: torch.Tensor, x: torch.Tensor, p: Params, dims: UniMoeDims,
        out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h + MoE(x)`` for rows h, x (N, C) (x the normed h), into ``out``
    if given, and the rows' routing weights.  One product for every
    expert's gate and up projections, one for the down projections of all
    of them with the residual added in its epilogue: the routed experts run
    over every row, weighted 0 where the row did not pick them."""
    weights = route(x, p["router_w"], dims.top_p, dims.top_k)
    gate, up = F.linear(x, p["experts_gu_w"]).split(dims.fused_width, dim=-1)
    act = weigh_experts(F.silu(gate).mul_(up), weights, dims)
    return torch.addmm(h, act, p["experts_down_w"].t(), out=out), weights


def _block_prefill(x: torch.Tensor, p: Params, dims: UniMoeDims, kv: torch.Tensor, cos, sin):
    """One block over whole sequences x (B, N, C), their K/V written to the
    layer's cache kv (B, 2 KVH, n_ctx, D) at positions 0..N-1."""
    B, N, C = x.shape
    H, KVH = dims.n_head, dims.n_kv_head
    qkv = _qkv(x, p, dims, cos[:N], sin[:N])
    kv[:, :, :N] = qkv[:, :, H:].transpose(1, 2)
    rep = H // KVH
    attn = F.scaled_dot_product_attention(qkv[:, :, :H].transpose(1, 2), kv[:, :KVH, :N].repeat_interleave(rep, 1),
                                          kv[:, KVH:, :N].repeat_interleave(rep, 1), is_causal=True)
    rows = x.reshape(B * N, C)
    h = torch.addmm(rows, attn.transpose(1, 2).reshape(B * N, H * dims.head_dim), p["o_w"].t())
    with span("moe"):
        out, weights = moe(h, rms_norm(h, p["moe_norm"], dims.rms_eps), p, dims)
    return out.view(B, N, C), weights


def logits(params: Params, dims: UniMoeDims, x: torch.Tensor) -> torch.Tensor:
    """The final RMSNorm and the head: rows x (B, C) -> f32 logits (B, V),
    products of compute-dtype values with f32 sums, unrounded."""
    h = rms_norm(x, params["norm"], dims.rms_eps)
    head = params["head"]
    if h.dtype == torch.float32:
        return F.linear(h, head)
    if h.is_cuda:
        return torch.mm(h, head.t(), out_dtype=torch.float32)
    return F.linear(h.float(), head.float())


def audio_tokens(params: Params, dims: UniMoeDims, features: torch.Tensor) -> torch.Tensor:
    """The connector: tower features (B, Ta, Ca) -> (B, n_audio_tokens, C)."""
    pooled = F.adaptive_avg_pool1d(features.transpose(1, 2), dims.n_audio_tokens).transpose(1, 2)
    return F.linear(pooled, params["connector_w"], params["connector_b"])


# attention's kernels: scaled_dot_product_attention's choice without cuDNN,
# which plans each new shape on the host (every K/V length of a decode)
_ATTENTION = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------


class MoeCounts:
    """The MoE layers' program counters, kept on the model's device and
    added to without a host sync; :meth:`read` copies them to the host.

    - ``token_layers``: tokens routed, each counted once in every layer it
      passes (a host int);
    - ``picks``: picks per expert over those, the routed experts first and
      the null experts last;
    - ``decode_layers``: decode steps times layers (a host int),
      ``decode_token_layers``: the tokens routed over those (a step's rows
      times its layers; a host int), and ``experts_hit``: over those, the
      routed experts that at least one of the step's rows picked."""

    def __init__(self, dims: UniMoeDims, device):
        self.n_routed = dims.n_expert
        self.token_layers = 0
        self.decode_layers = 0
        self.decode_token_layers = 0
        self.picks = torch.zeros(dims.n_expert + dims.n_null_expert, dtype=torch.int64, device=device)
        self.experts_hit = torch.zeros((), dtype=torch.int64, device=device)

    def add(self, weights: torch.Tensor, decode: bool) -> torch.Tensor:
        """Counts one pass's routing weights (L, N, E + E0) (decode: one
        token a row); returns each row's routed picks over the layers (N,)."""
        picked = weights > 0
        L, N = picked.shape[:2]
        self.token_layers += L * N
        self.picks += picked.sum((0, 1))
        routed = picked[..., : self.n_routed]
        if decode:
            self.decode_layers += L
            self.decode_token_layers += L * N
            self.experts_hit += routed.any(1).sum()
        return routed.sum((0, 2))

    def read(self) -> Dict[str, object]:
        return {"token_layers": self.token_layers, "decode_layers": self.decode_layers,
                "decode_token_layers": self.decode_token_layers, "n_routed": self.n_routed, "picks": self.picks.tolist(),
                "experts_hit": int(self.experts_hit)}


# ---------------------------------------------------------------------------
# The passes
# ---------------------------------------------------------------------------


def prefill(model: "UniMoe", features: torch.Tensor, before: Sequence[int], after: Sequence[int],
            kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The connector and the prefill of [before, audio tokens, after] for
    every row, its K/V in the first B rows of the cache ``kv``
    (:meth:`UniMoe.decoder`); returns the last
    position's hidden state (B, C), which :func:`logits` takes, and each
    row's routed picks (B,)."""
    params, dims = model.params, model.dims
    B = features.shape[0]
    embed = params["embed"]
    text = embed[torch.tensor(list(before) + list(after), dtype=torch.int64).to(embed.device)]
    n0 = len(before)
    x = torch.cat([text[:n0].expand(B, -1, -1), audio_tokens(params, dims, features).to(embed.dtype),
                   text[n0:].expand(B, -1, -1)], dim=1)
    N = x.shape[1]
    if N >= dims.n_ctx:
        raise ValueError(f"a window's prompt of {N} positions leaves no room in the cache of {dims.n_ctx}")
    weights = []
    with sdpa_kernel(_ATTENTION):
        for i, p in enumerate(params["layers"]):
            x, w = _block_prefill(x, p, dims, kv[i, :B], model.cos, model.sin)
            weights.append(w)
    routed = model.moe_counts.add(torch.stack(weights), decode=False).view(B, N).sum(1)
    return x[:, -1], routed


class Step:
    """The decode step of B rows of a model: one token a row at one
    position of every row, over the rows' K/V in the model's cache.

    Its tensors are fixed (the position, the attention mask's row, the
    residual stream, the routing weights), and attention reads the
    whole cache under a mask of the positions written, so that each
    layer's attention and MoE are the same launches at every step.  On a
    CUDA device the first step runs them on a side stream and captures
    every layer as one CUDA graph, which each later step replays: a step
    then costs the host a few launches in place of about a thousand.  On
    the CPU they run as they are, each MoE layer in a ``moe`` span."""

    def __init__(self, model: "UniMoe", kv: torch.Tensor, batch: int):
        dims, dev, dtype = model.dims, model.device, model.dtype
        self.model, self.B = model, batch
        self.kv = kv[:, :batch]
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.mask = torch.zeros((1, 1, 1, dims.n_ctx), dtype=dtype, device=dev)
        self.x = torch.zeros((batch, dims.n_state), dtype=dtype, device=dev)
        self.h = torch.zeros_like(self.x)
        self.weights = torch.zeros((dims.n_layer, batch, dims.n_expert + dims.n_null_expert), device=dev)
        self.graph: Optional[object] = None

    def _attention(self, i: int) -> None:
        """Layer i's attention block: x -> h."""
        m, dims = self.model, self.model.dims
        p, kv = m.params["layers"][i], self.kv[i]
        H, KVH, D = dims.n_head, dims.n_kv_head, dims.head_dim
        qkv = _qkv(self.x, p, dims, m.cos.index_select(0, self.pos), m.sin.index_select(0, self.pos))
        kv.index_copy_(2, self.pos, qkv[:, H:, None])
        q = qkv[:, :H].reshape(self.B, KVH, H // KVH, D)  # a K/V head's query heads as its rows
        attn = F.scaled_dot_product_attention(q, kv[:, :KVH], kv[:, KVH:], attn_mask=self.mask)
        torch.addmm(self.x, attn.reshape(self.B, H * D), p["o_w"].t(), out=self.h)

    def _moe(self, i: int) -> None:
        """Layer i's MoE block: h -> x, and its routing weights."""
        dims, p = self.model.dims, self.model.params["layers"][i]
        _, weights = moe(self.h, rms_norm(self.h, p["moe_norm"], dims.rms_eps), p, dims, out=self.x)
        self.weights[i].copy_(weights)

    def _layers(self, spans: bool) -> None:
        for i in range(self.model.dims.n_layer):
            self._attention(i)
            with span("moe") if spans else contextlib.nullcontext():
                self._moe(i)

    def _capture(self) -> None:
        """This step's layers run on a side stream, then captured there as
        one graph (with no span: a span may record CUDA events)."""
        stream, current = torch.cuda.Stream(self.x.device), torch.cuda.current_stream(self.x.device)
        stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self._layers(spans=True)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._layers(spans=False)
            finally:
                graph.capture_end()
        current.wait_stream(stream)
        self.graph = graph

    def __call__(self, tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,) at position ``pos`` -> their hidden states (B, C),
        which :func:`logits` takes (valid until the next step), and each
        row's routed picks over the layers (B,)."""
        m = self.model
        self.pos.fill_(pos)
        self.mask.copy_(m.mask_rows[pos])
        torch.index_select(m.params["embed"], 0, tokens, out=self.x)
        if self.graph is not None:
            self.graph.replay()
        else:
            with sdpa_kernel(_ATTENTION):
                if self.x.is_cuda:
                    self._capture()
                else:
                    self._layers(spans=True)
        return self.x, m.moe_counts.add(self.weights, decode=True)


@dataclass(eq=False)
class UniMoe:
    """The speech-to-text model: its sizes, parameters (see the module's
    docstring), the chat template's ids around a window's audio
    (``prompt``: ids before, ids after; they come with the model's
    tokenizer files), the RoPE tables and the attention masks' rows, the
    MoE counters, and the decoder's state: one self-attention K/V cache,
    (L, B, 2 KVH, n_ctx, D) (a layer's K heads, then its V heads; no
    cross-attention: the audio is a prefix of the sequence), of as many rows
    as the largest batch yet, and a :class:`Step` for each batch size.
    ``transcribe_batch`` runs it (one segment of token ids a 30 s window);
    one decode at a time (:meth:`decoder` is taken under ``lock``)."""

    dims: UniMoeDims
    params: Params = field(repr=False)
    prompt: Optional[Tuple[List[int], List[int]]] = None
    cos: torch.Tensor = field(init=False, repr=False)
    sin: torch.Tensor = field(init=False, repr=False)
    mask_rows: torch.Tensor = field(init=False, repr=False)
    moe_counts: MoeCounts = field(init=False, repr=False)

    def __post_init__(self):
        self.cos, self.sin = rope_tables(self.dims, self.dtype, self.device)
        n = self.dims.n_ctx
        keys = torch.arange(n, device=self.device)
        self.mask_rows = torch.zeros((n, n), dtype=self.dtype, device=self.device).masked_fill_(
            keys[None, :] > keys[:, None], float("-inf"))  # row t: the keys at positions <= t
        self.moe_counts = MoeCounts(self.dims, self.device)
        self.lock = threading.Lock()
        self._kv: Optional[torch.Tensor] = None
        self._steps: Dict[int, Step] = {}

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.params["embed"].dtype

    def decoder(self, batch: int) -> Tuple[torch.Tensor, Step]:
        """The K/V cache (its first ``batch`` rows are the decode's) and the
        step of ``batch`` rows; a batch larger than the cache makes a new
        cache and drops the steps captured over the old one."""
        if self._kv is None or self._kv.shape[1] < batch:
            self._steps.clear()
            self._kv = None
            d = self.dims
            self._kv = torch.zeros((d.n_layer, batch, 2 * d.n_kv_head, d.n_ctx, d.head_dim),
                                   dtype=self.dtype, device=self.device)
        if batch not in self._steps:
            self._steps[batch] = Step(self, self._kv, batch)
        return self._kv, self._steps[batch]

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """Mel windows (B, n_mels, 3000) -> tower features (B, Ta, Ca)."""
        return encoder_apply(self.params, self.dims.tower_dims, mel.to(self.device))
