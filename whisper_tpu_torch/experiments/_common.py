"""What the experiments (and chip_smoke.py) share: the device, timing and
the bound of a variant, from an H100 SXM's published peaks (NVIDIA's data
sheet; dense, at 700 W): 3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s f32 outside them.

``bound`` and its peaks are chip_smoke.py's yardstick for every kernel of
the port, and ``time_ms`` its timer: a change to either changes every
kernel's reading, so neither changes along with a kernel's speed work."""

import argparse
import time

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 outside them


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions and times the host")
    return ap


def device_of(name: str) -> torch.device:
    """The device asked for; a CUDA device that is not there is an error."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; pass --device cpu")
    return device


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (times from CUDA events)"
    return f"{device} (the kernels' plain versions; host times, not a card's)"


def time_ms(fn, device: torch.device, iters: int = 10, repeats: int = 1) -> float:
    """fn's mean time per call over iters calls after one warm-up, the best
    of repeats: CUDA events on a card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = 1e3 * (time.perf_counter() - t0) / iters
        best = min(best, ms)
    return best


def bound(n_bytes: float, n_ops: float, dtype: str) -> dict:
    """The least time the card could take for work that moves n_bytes and
    does n_ops operations of dtype ("bfloat16" or "float32"): {"bound_ms",
    "bound_by"}."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_ops / PEAK_OPS_PER_S[dtype]
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


def line(name: str, ms: float, kb: dict, extra: str = "") -> str:
    return (f"{name:44s}: {ms:9.4f} ms  bound {kb['bound_ms']:.4f} ms by {kb['bound_by']} "
            f"({kb['bound_ms'] / ms:.3f} of it){extra}")
