// Shared C entry points of the kernel library.
#include <cuda_runtime.h>

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The library links its own CUDA runtime, whose current device is its own:
// every launch first selects the device of the tensors it gets.
extern "C" int kernels_set_device(int device) { return cudaSetDevice(device); }
