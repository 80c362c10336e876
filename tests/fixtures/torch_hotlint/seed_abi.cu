// Seeded ABI fixture: read as text by the port's hotlint in tests, never
// compiled.  seed_abi.py declares this entry point one pointer short.
#include <cuda_runtime.h>

extern "C" int seed_kernel(const void* x, void* y, void* scratch, int n,
                           int m, void* stream) {
  return cudaSuccess;
}
