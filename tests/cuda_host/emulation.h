// Host emulation of the CUDA features pydens_tpu_torch/csrc/fused_taylor.cu
// uses, for running its kernels on the CPU in tests: one OS thread per CUDA
// thread, a std::barrier for __syncthreads, a per-block buffer for dynamic
// shared memory.  Blocks run one after another.
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

using std::min;

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct HostDim {
  unsigned x;
};
thread_local HostDim threadIdx, blockIdx;
HostDim gridDim, blockDim;
thread_local std::barrier<>* host_barrier;
thread_local float4* host_smem;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(threads, blocks)

// Runs body() as `grid` blocks of `threads` threads with `smem` bytes of
// shared memory each, filled with NaN so that a read before a write shows.
template <class F>
void host_launch(int grid, int threads, size_t smem, F body) {
  gridDim.x = grid;
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    std::vector<float4> shared(smem / sizeof(float4) + 1);
    std::fill(&shared[0].x, &shared[0].x + 4 * shared.size(), NAN);
    std::barrier<> bar(threads);
    std::vector<std::thread> team;
    for (int t = 0; t < threads; ++t)
      team.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        host_barrier = &bar;
        host_smem = shared.data();
        body();
      });
    for (auto& th : team) th.join();
  }
}
