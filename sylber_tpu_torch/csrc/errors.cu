// Error text for the codes the kernel entry points return.
#include <cuda_runtime.h>

extern "C" const char* sylber_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
