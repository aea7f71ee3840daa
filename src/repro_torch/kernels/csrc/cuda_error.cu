// The message of a cudaError_t, for the exceptions the kernel wrappers raise
// when a launch returns a non-zero code.

#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
