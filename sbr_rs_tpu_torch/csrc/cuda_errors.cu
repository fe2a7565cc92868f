// Error text for the codes the kernel entry points return
// (ops/_build.py:check turns them into Python exceptions).
#include <cuda_runtime.h>

extern "C" const char* sbr_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
