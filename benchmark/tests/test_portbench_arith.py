"""The yardstick's arithmetic against hand counts on small shapes, and the
readers of the per-layer metrics on a made-up trace."""

from types import SimpleNamespace

import pytest

from benchmark.harness import arith, spec, trace

whisper = spec.module("families", "whisper")

DIMS = dict(n_mels=2, n_audio_ctx=3, n_audio_state=4, n_audio_head=2, n_audio_layer=1,
            n_vocab=5, n_text_ctx=8, n_text_state=4, n_text_head=2, n_text_layer=2)


def test_k1_operations_and_bytes():
    ops, nbytes = arith.k1_ops(DIMS, windows=2)
    # per layer and window: 2 heads x (2 T^2 D for Q K^T + 2 T^2 D for P V), D = 2
    assert ops == 2 * 2 * (2 * 9 * 2 + 2 * 9 * 2)
    assert nbytes == 2 * 2 * 4 * 3 * 4  # q, k, v, o of (T, C) in bf16, two windows


def test_k2_launch_bytes():
    C, L, Ta = 4, 2, 3
    got = arith.k2_launch_bytes(DIMS, rows=2, audios=1, t_cache=5, positions=[3, 9], pending=1)
    weights = L * (14 * C * C + 16 * C)
    cross = 2 * L * 1 * Ta * C
    self_kv = 2 * L * C * ((3 + 1) + (5 + 1))  # the second row reads the whole cache
    io = 2 * 2 * C + 2 * L * 2 * C
    assert got == 2 * (weights + cross + self_kv + io)


def test_window_operations():
    M, Ta, C, L, V = 2, 3, 4, 2, 5
    encoder = 2 * 3 * M * C * 2 * Ta + 2 * 3 * C * C * Ta + 1 * (2 * Ta * 12 * C * C + 4 * Ta * Ta * C)
    cross = L * 2 * Ta * 2 * C * C
    prefill = L * (1 * 28 * C * C + 2 * 1 * C + 4 * 1 * Ta * C) + 4 * V * C
    decode = sum(L * (28 * C * C + 4 * (1 + s) * C + 4 * Ta * C) + 2 * V * C for s in range(2))
    assert whisper.window_ops(DIMS, prompt=1, steps=2) == encoder + cross + prefill + decode


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert arith.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert arith.bound_s(0, 989e12) == pytest.approx(1.0)
    assert arith.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_busy_time_counts_overlaps_once():
    assert trace.union([(3, 4), (0, 2), (1, 2.5)]) == [(0, 2.5), (3, 4)]
    busy = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert trace.covered(busy, [(0.0, 10.0)]) == pytest.approx(4.0)
    assert trace.covered(busy, [(1.5, 5.5), (8.0, 9.0)]) == pytest.approx(2.0)


def test_kernel_names_lose_namespaces_and_templates():
    name = "void (anonymous namespace)::gemv_tc_kernel<__nv_bfloat16, 2>(float const*, int)"
    assert trace.short_name(name) == "gemv_tc_kernel"
    assert trace.short_name("void at::native::elementwise_kernel<128, 2>(int)") == "elementwise_kernel"


class _Event:
    def __init__(self, name, start, dur, cuda, thread=1, op_id=0, launched_by=0):
        self._v = (name, int(start * 1e9), int(dur * 1e9), cuda, thread)
        self._ids = (op_id, launched_by)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._ids[0]

    def linked_correlation_id(self):
        return self._ids[1]


def made_up_trace():
    return trace.Trace([
        _Event(trace.WINDOW, 0.0, 10.0, False),
        _Event(trace.ROUND, 1.0, 2.0, False), _Event(trace.ROUND, 5.0, 1.0, False),
        _Event("void (anonymous namespace)::encoder_attention_wgmma_kernel<64>(x)", 1.0, 0.5, True),
        _Event("void (anonymous namespace)::gemv_tc_kernel<2>(x)", 1.5, 1.0, True),
        _Event("void at::native::elementwise_kernel<128, 2>(int)", 2.0, 0.125, True, launched_by=7),
        _Event("aten::mul", 1.9, 0.01, False, op_id=7),
        _Event("cudaLaunchKernel", 1.905, 0.001, False, op_id=7, launched_by=7),  # ids of its own space
        _Event("void (anonymous namespace)::decode_attention_kernel<1>(x)", 2.25, 0.25, True),
        _Event("Memcpy HtoD", 5.0, 0.5, True),
        _Event("aten::item", 3.0, 2.0, False),
    ])


def reader(name):
    return spec.metric_reader(name)


def test_metric_readers_on_a_made_up_trace():
    t = made_up_trace()
    assert t.window_s == pytest.approx(10.0) and t.busy_s() == pytest.approx(2.0)
    dims = dict(DIMS, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20, n_audio_layer=32)
    run = SimpleNamespace(trace=t, dims=dims, family=whisper, rounds=SimpleNamespace(audios=[1, 2]), windows=[(4, 10)], stats={"requests": 30, "batches": 4},
                          layouts={(16, 1): 3, (4, 1, "pending"): 1},
                          k2=SimpleNamespace(launches=lambda: [(2, 2, 8, [1, 2], 0)]))
    ops, nbytes = arith.k1_ops(dims, 3)
    assert reader("k1.roofline_pct")(run) == pytest.approx(100 * arith.bound_s(nbytes, ops) / 0.5)
    k2_bytes = arith.k2_launch_bytes(dims, 2, 2, 8, [1, 2], 0)
    assert reader("k2.roofline_pct")(run) == pytest.approx(100 * k2_bytes / arith.PEAK_BYTES_PER_S / 1.0)
    assert reader("idle_pct.batch")(run) == pytest.approx(80.0)
    # rounds: [1, 3] busy 1.5 (the kernels), [5, 6] busy 0.5 (the copy)
    assert reader("idle_pct.serve")(run) == pytest.approx(100 * (1 - 2.0 / 3.0))
    win = whisper.window_ops(dims, 4, 10)
    assert reader("mfu_pct.batch")(run) == pytest.approx(100 * win / arith.PEAK_OPS_PER_S / 10.0)
    assert reader("mfu_pct.serve")(run) == pytest.approx(100 * win / arith.PEAK_OPS_PER_S / 3.0)
    assert reader("serve.rows_per_batch")(run) == pytest.approx(7.5)
    assert reader("batch.rows_per_step")(run) == pytest.approx((16 * 3 + 4) / 4)
    breakdown = t.breakdown()
    assert breakdown["device_ops"][0] == ["gemv_tc_kernel", pytest.approx(1.0)]
    # a kernel named beside the host operation that launched it
    assert dict(breakdown["device_ops"])["elementwise_kernel <- aten::mul"] == pytest.approx(0.125)
    gaps = dict(breakdown["idle_gaps"])  # [0, 1], [2.5, 5] (aten::item at its middle), [5.5, 10]
    assert gaps["aten::item"] == pytest.approx(2.5)
    assert gaps["host between operations"] == pytest.approx(5.5)


def test_readers_return_nothing_without_a_trace():
    run = SimpleNamespace(trace=None, stats={}, layouts={}, windows=[])
    for m in spec.benchmark()["per_layer"]:
        assert reader(m["name"])(run) is None, m["name"]
