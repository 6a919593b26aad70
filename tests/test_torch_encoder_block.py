"""The encoder block's kernel route (``ops.kernels.encoder_block``) on the CPU.

Its wrappers take their plain versions on a CPU tensor, and those are the
torch route's own operations: the two routes must agree bit for bit.  The
route is chosen from the inputs alone; here ``models.whisper._on_card``
stands in for a CUDA tensor where a test needs the card's side of it.
"""

import pytest
import torch

from whisper_tpu_torch.models import whisper as W
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.ops.attention import merge_heads, split_heads
from whisper_tpu_torch.ops.kernels import encoder_block as eb
from whisper_tpu_torch.quantize import quantize_weight

C, H, F = 128, 2, 512  # head dim 64, as the kernels need
DIMS = ModelDimensions(n_mels=80, n_audio_ctx=16, n_audio_state=C, n_audio_head=H, n_audio_layer=2,
                       n_vocab=64, n_text_ctx=8, n_text_state=C, n_text_head=H, n_text_layer=1)


def _block(dtype, seed: int = 0, width: int = C, mlp: int = F) -> dict:
    """One block's parameters, biases and LayerNorm gains drawn too."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=0.05, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dtype)

    return {"attn_ln_g": r(width, scale=0.1, shift=1.0), "attn_ln_b": r(width),
            "q_w": r(width, width), "q_b": r(width), "k_w": r(width, width),
            "v_w": r(width, width), "v_b": r(width), "o_w": r(width, width), "o_b": r(width),
            "mlp_ln_g": r(width, scale=0.1, shift=1.0), "mlp_ln_b": r(width),
            "fc1_w": r(mlp, width), "fc1_b": r(mlp), "fc2_w": r(width, mlp), "fc2_b": r(width)}


def _x(dtype, B: int, T: int, width: int = C, seed: int = 1) -> torch.Tensor:
    return torch.randn((B, T, width), generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.fixture
def card(monkeypatch):
    """The route's device check answers as for a CUDA tensor."""
    monkeypatch.setattr(W, "_on_card", lambda x: True)


def _route(run) -> tuple:
    """run()'s output and the blocks it ran by route."""
    before = dict(W.encoder_apply.blocks_by_route)
    out = run()
    after = W.encoder_apply.blocks_by_route
    return out, {k: after[k] - before.get(k, 0) for k in ("kernels", "torch")}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T", [(1, 37), (2, 200)])
def test_kernel_route_equals_the_torch_route_bit_for_bit(dtype, B, T):
    p, x = _block(dtype), _x(dtype, B, T)
    assert torch.equal(W._encoder_block_kernels(x, p, H), W._encoder_block(x, p, H))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_versions_are_the_blocks_operations(dtype):
    p, x = _block(dtype, seed=2), _x(dtype, 2, 33, seed=3)
    h = W.layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
    assert W.layer_norm is eb.layer_norm_plain
    q, k, v = eb.qkv_plain(h, p["q_w"], p["q_b"], p["k_w"], None, p["v_w"], p["v_b"], H)
    for got, w, b in ((q, "q_w", "q_b"), (k, "k_w", None), (v, "v_w", "v_b")):
        want = split_heads(W._linear(h, p[w], None if b is None else p[b]), H).contiguous()
        assert got.is_contiguous() and torch.equal(got, want)
    attn = W.encoder_attention(q, k, v)
    assert torch.equal(eb.linear_plain(attn, p["o_w"], p["o_b"], residual=x),
                       x + W._linear(merge_heads(attn), p["o_w"], p["o_b"]))
    assert torch.equal(eb.linear_plain(h, p["fc1_w"], p["fc1_b"], gelu=True),
                       W._gelu(W._linear(h, p["fc1_w"], p["fc1_b"])))
    g = eb.linear_plain(h, p["fc1_w"], p["fc1_b"], gelu=True)
    assert torch.equal(eb.linear_plain(g, p["fc2_w"], p["fc2_b"], residual=x),
                       x + W._linear(g, p["fc2_w"], p["fc2_b"]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_take_their_plain_versions_on_the_cpu(dtype):
    p, x = _block(dtype, seed=4), _x(dtype, 1, 20, seed=5)
    assert torch.equal(eb.layer_norm(x, p["mlp_ln_g"], p["mlp_ln_b"]),
                       eb.layer_norm_plain(x, p["mlp_ln_g"], p["mlp_ln_b"]))
    assert torch.equal(eb.linear(x, p["fc1_w"], p["fc1_b"], gelu=True),
                       eb.linear_plain(x, p["fc1_w"], p["fc1_b"], gelu=True))
    got = eb.qkv(x, p["q_w"], p["q_b"], p["k_w"], None, p["v_w"], p["v_b"], H)
    want = eb.qkv_plain(x, p["q_w"], p["q_b"], p["k_w"], None, p["v_w"], p["v_b"], H)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_cpu_tensor_keeps_the_torch_route():
    p, x = _block(torch.bfloat16), _x(torch.bfloat16, 1, 9)
    out, routes = _route(lambda: W._encoder_block(x, p, H))
    assert routes == {"kernels": 0, "torch": 1}


def test_a_bf16_card_tensor_takes_the_kernels(card):
    p, x = _block(torch.bfloat16), _x(torch.bfloat16, 2, 40)
    out, routes = _route(lambda: W._encoder_block(x, p, H))
    assert routes == {"kernels": 1, "torch": 0}
    assert torch.equal(out, W._encoder_block_kernels(x, p, H))


def _shard(p: dict) -> dict:
    """The first of two model shards of p (one head of two): q, k, v and
    fc1 by output rows, o and fc2 by input columns, as shard_params cuts."""
    s = dict(p)
    for key in ("q_w", "q_b", "k_w", "v_w", "v_b"):
        s[key] = p[key][: C // 2]
    s["fc1_w"], s["fc1_b"] = p["fc1_w"][: F // 2], p["fc1_b"][: F // 2]
    s["o_w"], s["fc2_w"] = p["o_w"][:, : C // 2].contiguous(), p["fc2_w"][:, : F // 2].contiguous()
    return s


@pytest.mark.parametrize("case", ["f32", "autograd", "int8", "shard", "head_dim_32"])
def test_the_torch_route_keeps_what_the_kernels_do_not_take(card, monkeypatch, case):
    """On the card's side of the check, f32, a pass that takes gradients,
    an int8 weight, a model shard (its o and fc2 reduce before their bias
    and residual; the reduction here is the identity, one rank) and a head
    dim the kernels' layouts do not take each keep the torch route."""
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    p, x, heads = _block(dtype), _x(dtype, 1, 24), H
    if case == "autograd":
        p["fc2_w"].requires_grad_(True)
    elif case == "int8":
        p["fc1_w"] = quantize_weight(p["fc1_w"])
    elif case == "shard":
        monkeypatch.setattr(W, "reduce_from_model", lambda y: y)
        p, heads = _shard(p), 1
    elif case == "head_dim_32":
        heads = 4
    out, routes = _route(lambda: W._encoder_block(x, p, heads))
    assert routes == {"kernels": 0, "torch": 1}
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    if case == "autograd":
        out.float().sum().backward()
        assert p["fc2_w"].grad is not None


@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True)])
def test_encoder_apply_counts_its_blocks_and_routes_ln_post(card, monkeypatch, dtype, int8):
    """ln_post takes the blocks' route: the kernels after kernel blocks,
    the torch ops after torch blocks (an int8 model's leave the activation
    in the first block's (B, C, T) layout, which the kernel does not read)."""
    params = W.init_params(DIMS, torch.Generator().manual_seed(6), dtype)
    for key, v in params["encoder"]["blocks"].items():
        if key.endswith(("_b", "_g")):
            v.add_(torch.randn(v.shape, generator=torch.Generator().manual_seed(7)).to(dtype) * 0.1)
    if int8:
        params["encoder"]["blocks"]["fc1_w"] = quantize_weight(params["encoder"]["blocks"]["fc1_w"])
    mel = torch.randn((2, DIMS.n_mels, 2 * DIMS.n_audio_ctx), generator=torch.Generator().manual_seed(8))
    ln_calls = []
    kernel_ln = eb.layer_norm
    monkeypatch.setattr(eb, "layer_norm", lambda *a: ln_calls.append(1) or kernel_ln(*a))
    out, routes = _route(lambda: W.encoder_apply(params, DIMS, mel))
    on_kernels = dtype == torch.bfloat16 and not int8
    n = DIMS.n_audio_layer
    assert routes == ({"kernels": n, "torch": 0} if on_kernels else {"kernels": 0, "torch": n})
    assert len(ln_calls) == (2 * n + 1 if on_kernels else 0)  # attn_ln and mlp_ln a block, and ln_post
    monkeypatch.setattr(W, "_on_card", lambda x: False)
    ref, routes = _route(lambda: W.encoder_apply(params, DIMS, mel))
    assert routes == {"kernels": 0, "torch": n}
    assert out.shape == (2, DIMS.n_audio_ctx, C) and torch.equal(out, ref)


@pytest.mark.parametrize("row_tiles,n,segments,tile", [
    (12, 1280, 3, 128),   # q, k, v at one window: 180 tiles of 256 would take two waves of 132 SMs
    (12, 1280, 1, 128),   # o and fc2 at one window: 60 tiles of 256 fill under half
    (12, 5120, 1, 256),   # fc1 at one window
    (192, 1280, 3, 256),  # q, k, v at 16 windows (row tiles per window)
    (188, 1280, 1, 256),  # fc2 at 16 windows (rows tiled as one)
    (188, 5120, 1, 256),  # fc1 at 16 windows
])
def test_tile_n_fills_the_card_at_the_encoders_shapes(row_tiles, n, segments, tile):
    assert eb.tile_n(row_tiles, n, segments, 132) == tile


@pytest.mark.parametrize("call", ["linear", "qkv", "layer_norm"])
def test_the_wrappers_refuse_another_device(call):
    p, x = _block(torch.bfloat16), _x(torch.bfloat16, 1, 8).to("meta")
    p = {k: v.to("meta") for k, v in p.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        if call == "linear":
            eb.linear(x, p["fc1_w"], p["fc1_b"])
        elif call == "qkv":
            eb.qkv(x, p["q_w"], p["q_b"], p["k_w"], None, p["v_w"], p["v_b"], H)
        else:
            eb.layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])


def test_the_rounding_bound_covers_one_neighbour_per_rounding():
    """rounding_bound (the card tests' per-element bound) is one ulp of y
    without an epilogue, and grows by an ulp with each rounding after it."""
    x, w = _x(torch.bfloat16, 1, 16), _block(torch.bfloat16)["fc1_w"]
    b, res = torch.full((F,), 0.5, dtype=torch.bfloat16), torch.ones((1, 16, F), dtype=torch.bfloat16)
    bare = eb.rounding_bound(x, w)
    y = (x.float() @ w.float().t()).to(torch.bfloat16).float().abs()
    assert ((bare >= y * 2 ** -8) & (bare <= y * 2 ** -6)).all()
    biased, summed = eb.rounding_bound(x, w, b), eb.rounding_bound(x, w, b, residual=res)
    for more, less in ((biased, bare), (summed, biased)):  # a sum of exactly 0 rounds nothing
        assert (more >= less).all() and (more > less).float().mean() > 0.9
    gelu = eb.rounding_bound(x, w, b, gelu=True)
    assert gelu.shape == (1, 16, F) and (gelu > 0).all()
