// Shared C entry points of the kernel library.

#include <cuda_runtime.h>

extern "C" const char* mcptam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
