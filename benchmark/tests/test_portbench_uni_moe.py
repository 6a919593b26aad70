"""The Uni-MoE family end to end on the CPU: ``uni-moe.batch16`` cut to a
tiny width (``spec.Cell.of``), run by the harness as ``benchmark/run.py`` runs it.

The tiny cell runs the port in float32, so that the port and the float32
reference agree to rounding (about 1e-5 nats a token) and the limits can
sit far below what each planted fault and the float8 control read (0.05
nats a token and more at this width)."""

import copy
import time

import pytest
import torch

from benchmark.harness import cell, spec

LIMITS = {"tokens_wrong": 0, "failed": 0, "token_gap_median": 1e-3, "logprob_gap": 1e-3, "logprob_gap_max": 2e-3}
FAMILY = spec.module("families", "uni_moe")


def tiny() -> spec.Cell:
    c = spec.Cell("uni-moe.batch16")
    cfg = copy.deepcopy(c.config)
    cfg["dims"].update(n_audio_state=64, n_audio_head=2, n_audio_layer=2, n_audio_tokens=8, n_state=64,
                       n_layer=2, n_head=4, n_kv_head=2, n_vocab=512, n_ctx=40, expert_width=32,
                       shared_width=16, eos=511)
    cfg["assumed"]["chat_template"].update(ids_before_audio=3, ids_after_audio=2, ordinary_ids=500)
    cfg["dtype"] = "float32"
    mix = copy.deepcopy(c.mix)
    mix.update(batch_size=2, files_per_call=3, audio_s=80, length_s={"dist": "log_uniform", "low": 20, "high": 70})
    mix["forced"]["text_tokens"] = 9
    mix["check"]["requests"] = 3
    return spec.Cell.of(c.name, cfg, mix, dict(LIMITS), c.end_to_end, c.per_layer)


@pytest.fixture(autouse=True)
def _unpinned():
    yield
    FAMILY.unpin()


def _run(traced=False, products=None):
    r = cell.Run(tiny(), 2**33 + 5, 0.3, traced, torch.device("cpu"), time.perf_counter())
    r.setup()
    r.window()
    r.close()
    metrics = r.per_layer() if traced else r.end_to_end()
    checks = r.judge(products)
    return metrics, checks


def test_the_tiny_cell_is_correct_and_reads_its_metrics():
    metrics, checks = _run()
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert checks["logprob_gap_max"]["value"] < 1e-4 and checks["token_gap_median"]["value"] < 1e-4
    assert set(metrics) == {"audio_s_per_s", "peak_mem_gib", "setup_s"}


def test_a_traced_run_reads_the_moe_counters():
    metrics, checks = _run(traced=True)
    assert {"moe.experts_per_step", "moe.routed_per_token", "lm.rows_per_step", "mfu_pct.batch",
            "idle_pct.batch", "engine.step_host_ms"} == set(metrics)
    assert 1 <= metrics["moe.experts_per_step"]["value"] <= 4
    assert 0 < metrics["moe.routed_per_token"]["value"] <= 2
    assert 1 <= metrics["lm.rows_per_step"]["value"] <= 2  # the tiny mix's batch_size
    assert metrics["mfu_pct.batch"]["value"] > 0


def test_the_float8_control_is_not_correct():
    _, checks = _run(products="fp8")
    assert checks["logprob_gap"]["value"] > 10 * LIMITS["logprob_gap"]
    assert checks["token_gap_median"]["value"] > 10 * LIMITS["token_gap_median"]


@pytest.mark.parametrize("fault", sorted(FAMILY.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    with FAMILY.FAULTS[fault]():
        _, checks = _run()
    assert any(c["value"] > c["limit"] for c in checks.values()), (fault, checks)


def test_the_work_of_a_window_counts_its_routed_picks():
    dims = spec.Cell("uni-moe.batch16").dims
    work = FAMILY.window_work([{"segments": [{"prompt_tokens": 232, "tokens": [5] * 109, "routed_picks": 100}]}])
    assert work == [(232, 110, 100)]
    extra = FAMILY.window_ops(dims, 232, 110, 101) - FAMILY.window_ops(dims, 232, 110, 100)
    assert extra == pytest.approx(2 * 3 * dims["n_state"] * dims["expert_width"])
