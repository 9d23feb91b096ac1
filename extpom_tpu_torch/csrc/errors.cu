// CUDA error text for the status codes the kernel entry points return.
#include <cuda_runtime.h>

extern "C" const char* extpom_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
