"""The encoder block's projections and LayerNorm as hand-written Hopper kernels.

Replace no TPU kernel: whisper_tpu leaves the encoder's products and their
pointwise work to XLA, which fuses the bias, GELU and residual adds into
them.  Here the block's torch route (``models.whisper._encoder_block``)
makes about twenty pointwise passes a layer around its library products;
its kernel route makes none:

- :func:`linear` and :func:`qkv`: a persistent TMA + wgmma GEMM that reads
  the weights in their own (out, in) layout and rounds where ``_linear``
  and the block round, with a bias, erf-GELU or residual epilogue; q, k and
  v in one launch, stored in K1's (B, H, T, D) layout; the o projection
  reads K1's output in that layout in place.
- :func:`layer_norm`: one read and one write of the rows, f32 statistics.

The kernels are ``whisper_tpu_torch/csrc/encoder_block.cu`` (its header
says what bounds them and how they are laid out).  :func:`linear_plain`,
:func:`qkv_plain` and :func:`layer_norm_plain` are the same functions in
PyTorch: the torch route's own operations, which a CPU tensor takes.  The
kernels are bf16 only; f32 runs the torch route.
"""

import functools
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..attention import merge_heads, split_heads
from . import _lib
from .matmul_residual import _ulp_bound

BM = 128  # csrc/encoder_block.cu: the row tile
TILE_N = (256, 128)  # the column tiles it is built for
BK = 32  # K is a multiple of it
# a 128-wide tile costs more than half a 256-wide one (per operation it
# reads its x rows from shared memory twice as often)
_NARROW_COST = 1.15
_EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2}
GELU_SLOPE = 1.13  # the largest slope of erf-GELU, 1.1289 near 1.5


def layer_norm_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics, output cast back to input dtype."""
    orig_dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    x = (x - mean) * torch.rsqrt(var + 1e-5)
    x = x * g.float() + b.float()
    return x.to(orig_dtype)


def linear_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                 gelu: bool = False, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T`` rounded to x's dtype, ``+ bias`` rounded, then erf-GELU
    (``gelu``) or ``residual +`` (each rounded): the block's ``_linear``,
    ``_gelu`` and residual add.  A 4-D x is K1's (B, H, T, D) output, taken
    through ``merge_heads``."""
    if x.dim() == 4:
        x = merge_heads(x)
    y = F.linear(x, w)
    if bias is not None:
        y = y + bias
    if gelu:
        y = F.gelu(y)
    return y if residual is None else residual + y


def qkv_plain(h: torch.Tensor, wq: torch.Tensor, bq: Optional[torch.Tensor], wk: torch.Tensor,
              bk: Optional[torch.Tensor], wv: torch.Tensor, bv: Optional[torch.Tensor],
              n_head: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block's q, k and v projections of h (B, T, C), each in K1's
    (B, H, T, D) layout (``split_heads(...).contiguous()``)."""
    return tuple(split_heads(linear_plain(h, w, b), n_head).contiguous()
                 for w, b in ((wq, bq), (wk, bk), (wv, bv)))


def rounding_bound(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   gelu: bool = False, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """How far, per element, a correct bf16 kernel may lie from
    :func:`linear_plain` (E1's ``bf16_rounding_bound``, by epilogue).  The
    two f32 products sum in other orders, so ``y = bf16(x @ w.T)`` may land
    one ulp of |y| apart; each later rounding may part them by one ulp
    more: of ``t = y + bias``, then of the residual sum.  GELU's slope is at
    most 1.13, so it carries the parting of t at most 1.13-fold, then its
    output rounds (one ulp) and its erf may differ in the last f32 place
    (one ulp more).  Each ulp at the plain value's binade, or the next one
    up within an ulp of a power of two."""
    if x.dim() == 4:
        x = merge_heads(x)
    y = torch.matmul(x.float(), w.float().t()).to(torch.bfloat16)
    t, apart = y, _ulp_bound(y)
    if bias is not None:
        t = y + bias
        apart = apart + _ulp_bound(t)
    if gelu:
        return GELU_SLOPE * apart + 2 * _ulp_bound(F.gelu(t))
    if residual is not None:
        return apart + _ulp_bound(t + residual)
    return apart


def fits(k: int, n: int) -> bool:
    """Whether the GEMM takes (.., K) x (N, K)^T: K a multiple of 32, N of 8
    (E1's ``fits``: 16-byte rows for TMA)."""
    return k >= BK and k % BK == 0 and n >= 8 and n % 8 == 0


def tile_n(row_tiles: int, n: int, segments: int, sms: int) -> int:
    """The column tile (256 or 128) whose persistent grid finishes first:
    each SM takes ceil(tiles / sms) tiles in turn, a 128-wide tile at
    ``_NARROW_COST`` of half a 256-wide one.  At B = 1 (12 row tiles of
    1500 frames) the 1280-wide projections fill only 60 of 132 SMs with
    256-wide tiles and take 128; fc1 (5120 wide) and every projection at
    16 windows take 256.  Timed both ways at those shapes, the choice was
    the faster tile in each (H100; PERF.md)."""
    def cost(bn):
        tiles = row_tiles * segments * -(-n // bn)
        return -(-tiles // sms) * bn * (_NARROW_COST if bn == 128 else 1.0)

    return min(TILE_N, key=cost)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, *tensors) -> None:
    for t in tensors:
        if t is None:
            continue
        if t.dtype != torch.bfloat16 or t.device != tensors[0].device or not t.is_contiguous():
            raise ValueError(f"{name} kernel: every tensor contiguous bf16 on {tensors[0].device} "
                             f"(f32 runs the torch route), got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: every tensor must start on a 16-byte boundary (TMA, vector loads)")


def _launch(epilogue: str, x: torch.Tensor, ws, biases, outs, res, G: int, T: int, K: int, N: int,
            D: int, a_heads: bool, out_heads: bool, bn: Optional[int] = None) -> None:
    """One launch of the GEMM over len(ws) segments (G groups of T rows);
    ``bn`` the column tile, else :func:`tile_n`'s."""
    if bn is None:
        bn = tile_n(G * -(-T // BM), N, len(ws), _sm_count(x.device))

    def three(tensors):  # the C entry's three slots, null where absent
        return [None if t is None else t.data_ptr() for t in tensors] + [None] * (3 - len(tensors))

    err = _lib.lib().encoder_linear(
        _EPILOGUES[epilogue], bn, int(a_heads), int(out_heads), len(ws), x.data_ptr(), *three(ws),
        *three(biases), None if res is None else res.data_ptr(), *three(outs), G, T, K, N, D,
        _lib.stream_ptr(x.device),
    )
    _lib.check(err, "encoder_linear")


def linear(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *, gelu: bool = False,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`linear_plain` as one kernel: x (..., K), or K1's (B, H, T, D)
    output (K = H D, D a multiple of 64) read in place, giving (B, T, N); w
    (N, K); bias (N,) or None; at most one of ``gelu`` and ``residual``
    (x's rows by N).  A CPU tensor takes :func:`linear_plain`; a CUDA tensor
    launches the kernel (bf16, contiguous, 16-byte aligned, ``fits(K, N)``)
    or raises."""
    if x.device.type == "cpu":
        return linear_plain(x, w, bias, gelu=gelu, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"encoder_linear kernel: unsupported device {x.device}")
    _lib.refuse_grad("encoder_linear", x, w, bias, residual)
    if gelu and residual is not None:
        raise ValueError("encoder_linear kernel: one epilogue, GELU or the residual")
    heads_in = x.dim() == 4
    if heads_in:
        B, H, T, D = x.shape
        K, lead, G = H * D, (B, T), B
        if D % 64:
            raise ValueError(f"encoder_linear kernel: K1's layout needs a head dim a multiple of 64, got {D}")
    else:
        K, lead, D = x.shape[-1], x.shape[:-1], 64
        G, T = 1, x.numel() // max(K, 1)
    N = w.shape[0]
    if w.dim() != 2 or w.shape[1] != K or (bias is not None and tuple(bias.shape) != (N,)):
        raise ValueError(f"encoder_linear kernel: w ({K} in) and bias ({N},), got {tuple(w.shape)}, "
                         f"{None if bias is None else tuple(bias.shape)}")
    if residual is not None and tuple(residual.shape) != (*lead, N):
        raise ValueError(f"encoder_linear kernel: residual {(*lead, N)}, got {tuple(residual.shape)}")
    if not fits(K, N) or G * T < 1:
        raise ValueError(f"encoder_linear kernel: K={K} (a multiple of {BK}) and N={N} (of 8), rows >= 1")
    _check("encoder_linear", x, w, bias, residual)
    out = torch.empty(*lead, N, dtype=x.dtype, device=x.device)
    epilogue = "gelu" if gelu else "residual" if residual is not None else "bias"
    _launch(epilogue, x, [w], [bias], [out], residual, G, T, K, N, D, heads_in, False)
    _lib.count_launch(linear, layout=epilogue)
    return out


def qkv(h: torch.Tensor, wq: torch.Tensor, bq: Optional[torch.Tensor], wk: torch.Tensor,
        bk: Optional[torch.Tensor], wv: torch.Tensor, bv: Optional[torch.Tensor],
        n_head: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`qkv_plain` as one launch of the GEMM over the three weights
    (each (N, C), N = n_head D), each output stored in K1's (B, H, T, D)
    layout.  A CPU tensor takes :func:`qkv_plain`; a CUDA tensor launches
    the kernel (h (B, T, C), as :func:`linear`) or raises."""
    if h.device.type == "cpu":
        return qkv_plain(h, wq, bq, wk, bk, wv, bv, n_head)
    if h.device.type != "cuda":
        raise ValueError(f"encoder_linear kernel: unsupported device {h.device}")
    ws, bs = (wq, wk, wv), (bq, bk, bv)
    _lib.refuse_grad("encoder_linear", h, ws, [b for b in bs if b is not None])
    if h.dim() != 3:
        raise ValueError(f"encoder_linear kernel: h (B, T, C), got {tuple(h.shape)}")
    (B, T, K), N = h.shape, wq.shape[0]
    if N % n_head or (N // n_head) % 64:
        raise ValueError(f"encoder_linear kernel: {N} columns in {n_head} heads of a width a multiple of 64")
    for w, b in zip(ws, bs):
        if tuple(w.shape) != (N, K) or (b is not None and tuple(b.shape) != (N,)):
            raise ValueError(f"encoder_linear kernel: q, k, v weights ({N}, {K}) and biases ({N},), got "
                             f"{tuple(w.shape)}, {None if b is None else tuple(b.shape)}")
    if not fits(K, N) or B * T < 1:
        raise ValueError(f"encoder_linear kernel: K={K} (a multiple of {BK}) and N={N} (of 8), rows >= 1")
    _check("encoder_linear", h, *ws, *bs)
    D = N // n_head
    outs = [torch.empty(B, n_head, T, D, dtype=h.dtype, device=h.device) for _ in range(3)]
    _launch("bias", h, ws, bs, outs, None, B, T, K, N, D, False, True)
    _lib.count_launch(linear, layout="qkv")
    return tuple(outs)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`layer_norm_plain` over the last dim as one kernel.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (bf16,
    contiguous, 16-byte aligned, a width a multiple of 8 up to 2048) or
    raises."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, g, b)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm kernel: unsupported device {x.device}")
    _lib.refuse_grad("layer_norm", x, g, b)
    C = x.shape[-1]
    if tuple(g.shape) != (C,) or tuple(b.shape) != (C,) or C % 8 or not 8 <= C <= 2048 or x.numel() == 0:
        raise ValueError(f"layer_norm kernel: rows of a width a multiple of 8 up to 2048, g and b ({C},), "
                         f"got {tuple(x.shape)}, {tuple(g.shape)}, {tuple(b.shape)}")
    _check("layer_norm", x, g, b)
    out = torch.empty_like(x)
    err = _lib.lib().layer_norm_rows(x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     x.numel() // C, C, _lib.stream_ptr(x.device))
    _lib.check(err, "layer_norm_rows")
    _lib.count_launch(layer_norm)
    return out


linear.launches = 0
linear.launches_by_layout = Counter()  # by epilogue: "qkv", "bias", "gelu", "residual"
layer_norm.launches = 0
