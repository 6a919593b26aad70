"""The yardstick: an H100 SXM's published peaks, and the operations and
bytes of K1's and K2's work counted from shapes (a model family's own
operations are the family's: ``window_ops``).

The peaks are NVIDIA's data sheet's, dense, at a 700 W power limit:
3.35 TB/s of HBM3, 989 TFLOP/s in bf16 on the tensor cores.  The counts
follow ``chip_smoke.k2_bound`` and ``experiments/_common.bound`` (bytes read
once, two operations a multiply-add), restated for a whole window's
launches.
"""

from typing import Dict, Iterable, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 989e12  # bf16, tensor cores


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take for work that moves n_bytes and
    does n_ops bf16 operations."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S)


def k1_ops(dims: Dict[str, int], windows: int) -> Tuple[float, float]:
    """(operations, bytes) of K1 over ``windows`` encoder passes: per layer
    and window 4 H T^2 D (Q K^T and P V), and q, k, v read and o written
    once in bf16."""
    T, C, L = dims["n_audio_ctx"], dims["n_audio_state"], dims["n_audio_layer"]
    return 4.0 * T * T * C * L * windows, 2.0 * 4 * T * C * L * windows


def k2_launch_bytes(dims: Dict[str, int], rows: int, audios: int, t_cache: int,
                    positions: Iterable[int], pending: int, elem: int = 2) -> float:
    """Bytes one launch of K2 needs once: every decoder weight of the L
    layers (the eight projections, biases and LayerNorms), each audio's
    cross K/V, each row's self K/V up to its position (at most the cache's
    T) and its pending columns, x read and the hidden state and the new K/V
    written."""
    C, L, Ta = dims["n_text_state"], dims["n_text_layer"], dims["n_audio_ctx"]
    weights = L * (14 * C * C + 16 * C)  # 6 C^2 attention + 8 C^2 MLP; 10 C of biases, 3 LayerNorms
    cross = 2 * L * audios * Ta * C
    self_kv = 2 * L * C * sum(min(max(int(p), 0), t_cache) + pending for p in positions)
    io = 2 * rows * C + 2 * L * rows * C
    return float(elem * (weights + cross + self_kv + io))

