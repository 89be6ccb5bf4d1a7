// Error text for the cudaError_t that every launcher returns.
#include <cuda_runtime.h>

extern "C" const char* coloc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
