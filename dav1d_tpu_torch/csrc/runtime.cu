// Error strings for the wrappers' exceptions, and an empty kernel: the
// device time of a launch that does nothing (chip_smoke.py times it as
// the floor under every kernel's launch time).
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

DTPU_API const char* dtpu_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// One CTA of one thread that returns at once.  Returns cudaError_t.
DTPU_API int dtpu_empty(void* stream) {
    empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
