// An empty kernel: what one launch costs on this card.
//
// No counterpart in the JAX package and not on any model path. The bound of
// the semantic tokenizer (csrc/tokenizer.cu) is a few microseconds, of the
// order of a launch itself; chip_smoke.py times this kernel, launched back to
// back through the same ctypes route as the port's kernels, and prints the
// result beside that bound.
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
