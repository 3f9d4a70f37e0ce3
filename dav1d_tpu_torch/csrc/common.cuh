// Shared helpers of the port's kernels (plain C interface, loaded with
// ctypes by dav1d_tpu_torch/kernels/build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DTPU_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int dtpu_abs(int v) { return v < 0 ? -v : v; }

__device__ __forceinline__ int dtpu_clip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// floor(log2(v)) for v >= 1
__device__ __forceinline__ int dtpu_ulog2(int v) { return 31 - __clz(v); }

static inline unsigned dtpu_blocks(long long n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}
