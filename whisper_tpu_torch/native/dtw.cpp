// Copy of whisper_tpu/native/dtw.cpp, unchanged below this header, so that
// whisper_tpu_torch builds its host library from its own tree.

// DTW backtrace on host.
//
// The forward DTW cost/trace computation runs on TPU (anti-diagonal wavefront,
// see whisper_tpu/ops/dtw.py; algorithmic parity with reference
// whisper/timing.py:82-105 and the Triton wavefront in triton_ops.py:13-40).
// The backtrace is an inherently sequential pointer chase, so it stays on the
// host in C++ (reference uses numba @jit, whisper/timing.py:57-79).

#include <cstdint>

extern "C" {

// trace: (N+1) x (M+1) int32 matrix, row-major; values 0=diag, 1=up, 2=left.
// Writes the alignment path (text_idx, time_idx) pairs in forward order into
// out_i/out_j (each of capacity >= N+M) and returns the path length.
int32_t dtw_backtrace(int32_t* trace, int32_t n1, int32_t m1, int32_t* out_i,
                      int32_t* out_j) {
    // boundary rows force the walk to terminate at (0, 0)
    for (int32_t j = 0; j < m1; ++j) trace[j] = 2;
    for (int32_t i = 0; i < n1; ++i) trace[i * m1] = 1;

    int32_t i = n1 - 1;
    int32_t j = m1 - 1;
    int32_t count = 0;
    while (i > 0 || j > 0) {
        out_i[count] = i - 1;
        out_j[count] = j - 1;
        ++count;
        int32_t t = trace[i * m1 + j];
        if (t == 0) {
            --i;
            --j;
        } else if (t == 1) {
            --i;
        } else if (t == 2) {
            --j;
        } else {
            return -1;  // corrupt trace
        }
    }
    // reverse in place to forward order
    for (int32_t k = 0; k < count / 2; ++k) {
        int32_t ti = out_i[k], tj = out_j[k];
        out_i[k] = out_i[count - 1 - k];
        out_j[k] = out_j[count - 1 - k];
        out_i[count - 1 - k] = ti;
        out_j[count - 1 - k] = tj;
    }
    return count;
}

}  // extern "C"
