// An empty kernel, for measuring the launch floor of a grid: the device
// time that any kernel with the same grid and block takes before it does
// any work (chip_smoke.py's `floor_ms`, tools/torch_nn_ab.py). No path of
// the pipeline launches it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int locus_empty(int gx, int gy, int gz, int threads, void* stream) {
  empty_kernel<<<dim3(gx, gy, gz), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
