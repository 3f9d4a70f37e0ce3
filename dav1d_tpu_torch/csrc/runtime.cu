// Error strings for the wrappers' exceptions.
#include "common.cuh"

DTPU_API const char* dtpu_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
