// Helpers shared by every kernel entry point of libfm_kernels.so.

#include <cuda_runtime.h>

// Text of a CUDA error code returned by a launch function.
extern "C" const char* fm_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
