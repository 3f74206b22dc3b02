// Host emulation of the CUDA features pydens_tpu_torch/csrc/fused_taylor.cu
// and fused_mlp.cu use, for running their kernels on the CPU in tests: one
// OS thread per CUDA thread, a std::barrier for __syncthreads, a per-block
// buffer for dynamic shared memory, cp.async copies held per thread until
// their group is waited for.  Blocks run one after another, over a grid's
// x and then y axis (an ensemble's members).
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
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
  unsigned x, y;
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
inline size_t __cvta_generic_to_shared(const void* p) {
  return reinterpret_cast<size_t>(p);
}

// cp.async: a copy lands only when cp.async.wait_group lets its committed
// group complete (all but the newest `pending` groups), so a read of a
// slot before its wait and barrier sees what the slot held before.
struct HostCopy {
  void* dst;
  const void* src;
  size_t bytes;
};
thread_local std::vector<HostCopy> host_cp_open;
thread_local std::vector<std::vector<HostCopy>> host_cp_groups;
inline void host_cp_async(void* dst, const void* src, size_t bytes) {
  host_cp_open.push_back({dst, src, bytes});
}
inline void host_cp_commit() {
  host_cp_groups.push_back(std::move(host_cp_open));
  host_cp_open.clear();
}
inline void host_cp_wait(size_t pending) {
  while (host_cp_groups.size() > pending) {
    for (const HostCopy& c : host_cp_groups.front())
      std::memcpy(c.dst, c.src, c.bytes);
    host_cp_groups.erase(host_cp_groups.begin());
  }
}

// Runs body() as `grid` x `grid_y` blocks of `threads` threads with `smem`
// bytes of shared memory each, filled with NaN so that a read before a
// write shows.
template <class F>
void host_launch(int grid, int threads, size_t smem, F body, int grid_y = 1) {
  gridDim.x = grid;
  gridDim.y = grid_y;
  blockDim.x = threads;
  for (int b = 0; b < grid * grid_y; ++b) {
    std::vector<float4> shared(smem / sizeof(float4) + 1);
    std::fill(&shared[0].x, &shared[0].x + 4 * shared.size(), NAN);
    std::barrier<> bar(threads);
    std::vector<std::thread> team;
    for (int t = 0; t < threads; ++t)
      team.emplace_back([&, t] {
        threadIdx.x = t;
        threadIdx.y = 0;
        blockIdx.x = b % grid;
        blockIdx.y = b / grid;
        host_barrier = &bar;
        host_smem = shared.data();
        body();
      });
    for (auto& th : team) th.join();
  }
}
