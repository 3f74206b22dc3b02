// Fused forward of a layout-string MLP chain (tokens f, c, a, R, +).
//
// Replaces the Pallas kernel of pydens_tpu/ops/pallas_mlp.py built by
// make_fused_mlp_forward (`fused_apply`, body `kernel`): a batch-tiled
// forward with the weights resident on-chip and the activations, skip stack
// included, never leaving it.
//
// What bounds it on an H100: per point, sum(K*N) f32 FMAs against
// 4 * (in_dim + out_dim) bytes of device memory (1,152 FMAs for 16 bytes at
// [32, 32, 1] and 3 inputs), so by the data sheet the FMAs bound it.  But
// every FMA takes an issue slot, as do the shared-memory loads that feed
// it, and each activation adds five instructions, two of them on the
// special-function unit: at narrow widths (37 activations for 345 FMAs per
// point at [10, 12, 15, 1]) the activations and the per-layer epilogues
// issue about half as many instructions as the FMAs.  Short K loops and a
// barrier after every layer leave the latency of the shared loads and of
// the special-function unit exposed, so the kernel stays well under the
// issue rate as well.  At a few thousand points a launch costs its latency.
//
// The first design ran one thread per point, 64 points per block; every
// block copied all the weights into shared memory, and each thread walked
// its point's dependent FMA chain with its state and its weight read from
// shared memory for every FMA.  Two shared loads per FMA cap such a loop
// near 1/8 of the FMA rate.  On an NVIDIA H100 80GB HBM3 at 700 W, at
// 1,048,576 points and 3 inputs, it took 0.4014 ms at `fa fa f` [32, 32, 1],
// 0.1548 ms at `fa fa fa f` [10, 12, 15, 1] and 0.2301 ms at `faR fa fa+ f`
// [16, 16, 16, 1]: 7-9% of the FMA bound.
//
// This design:
// * A tile of TILE points (128, or 64 or 32 where shared memory needs it) is
//   the unit of work, and THREADS threads work on it together.  Its state
//   lives in shared memory as [feature][point].  In a dense layer each
//   thread owns a register tile of 4 points x 4 consecutive output features
//   and accumulates over K from one 16-byte state load and one 16-byte
//   weight load per 16 FMAs.  The 32 threads of a warp share their features
//   and take 128 consecutive points, so their weight loads are broadcasts
//   and their state loads contiguous.  (Eight features a thread, where the
//   width allows it, was faster only at width 64 and slower at the narrow
//   chains that predict runs, so it was left out.)
// * The weights are staged once per block with cp.async, each dense layer as
//   K + 1 rows of 4 * ceil(N / 4) floats (the bias last, zeros beyond N), so
//   a thread's weights are aligned 16-byte loads.
// * Bias and activation are applied in registers before the tile of the
//   next state is stored.  tanh is 1 - 2 / (1 + e^2v) and sigmoid
//   1 / (1 + e^-v), each from the special-function unit's exp2 and
//   reciprocal approximations (ex2.approx, rcp.approx): about 1e-7 from
//   the exact functions, far inside the 2e-5 value tolerance, in five
//   instructions where tanhf takes about twenty.  sin stays sinf and, like
//   an activation that does not follow a dense layer, runs as a pass of
//   its own.
// * The skip stack is extra state planes in shared memory; a push copies
//   the state into the next plane, an add sums the top plane into it.
// * Persistent blocks: the wrapper launches at most as many blocks as the
//   SMs hold at once; each walks the tiles blockIdx.x, blockIdx.x +
//   gridDim.x, ... and fetches the next tile's points with cp.async while it
//   computes the current one.  Loads of x and stores of out are coalesced;
//   the ragged last tile is masked.
// * f32 FMA only: TF32 would miss the 2e-5 value tolerance, and the FMA
//   pipe is not what binds, so the error-compensated 3xTF32 route was not
//   taken.
// * An ensemble's members (the Solver's n_models, one predict for all) are
//   the grid's second axis: block (b, k) stages member k's packed weights
//   (from k * P) and writes member k's slice of `out` (members, n,
//   out_dim); the points are shared.  The wrapper gives each member
//   max(1, slots / K) blocks, capped by the tiles; K = 1 is the single
//   model's grid.
//
// Op table (int32, built by pydens_tpu_torch/ops/fused_mlp.py):
//   [0] n_ops [1] in_dim [2] wmax [3] max_stack [4] staged weight floats
//   then n_ops records of OP_INTS ints:
//     dense: 0, K, N, w_off (packed), s_off (staged), act (-1: none)
//     act:   1, width, act_kind (0 tanh, 1 sigmoid, 2 sin), 0, 0, 0
//     push:  2, width, 0, 0, 0, 0        ('R')
//     add:   3, width, 0, 0, 0, 0        ('+')

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS_PER_SM = 8;  // caps registers at 64 a thread
constexpr int ROW_PAD = 4;  // state row stride TILE + 4: 16-byte aligned
constexpr int OP_INTS = 6;
constexpr int HEADER_INTS = 5;

struct Plan {
  int n_ops, in_dim, wmax, max_stack, staged;
  const int* ops;
};

__device__ Plan read_plan(const int* tab) {
  Plan p;
  p.n_ops = tab[0];
  p.in_dim = tab[1];
  p.wmax = tab[2];
  p.max_stack = tab[3];
  p.staged = tab[4];
  p.ops = tab + HEADER_INTS;
  return p;
}

__host__ __device__ int round4(int v) { return (v + 3) & ~3; }

// Shared memory of one block, in floats: the staged weights, the staging
// buffer of a tile's points, and 2 + max_stack state planes.
__host__ __device__ size_t mlp_smem_floats(int staged, int in_dim, int wmax,
                                           int max_stack, int tile) {
  return (size_t)staged + round4(tile * in_dim) +
         (size_t)(2 + max_stack) * wmax * (tile + ROW_PAD);
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Starts the copy of every dense layer's weights into shared memory (see
// the note at the top), and fills the padding with zeros.
__device__ void stage_weights(const Plan& p, float* ws,
                              const float* __restrict__ w) {
  for (int o = 0; o < p.n_ops; ++o) {
    const int* op = p.ops + o * OP_INTS;
    if (op[0] != 0) continue;
    const int K = op[1], N = op[2], npad = round4(N);
    const float* src = w + op[3];
    float* dst = ws + op[4];
    for (int i = threadIdx.x; i < (K + 1) * npad; i += THREADS) {
      const int r = i / npad, c = i - r * npad;
      if (c < N)
        copy_async4(dst + i, src + r * N + c);
      else
        dst[i] = 0.f;
    }
  }
}

// Starts the copy of tile t's points (in_dim floats each, row-major) into
// `stage`, 16 bytes at a time where x allows it.
template <int TILE>
__device__ void fetch_points(const Plan& p, float* stage,
                             const float* __restrict__ x, int n, int t) {
  const float* src = x + (size_t)t * TILE * p.in_dim;
  const int count = min(TILE, n - t * TILE) * p.in_dim;
  const bool aligned = (reinterpret_cast<size_t>(x) & 15) == 0;
  const int vec = aligned ? count >> 2 : 0;
  for (int i = threadIdx.x; i < vec; i += THREADS)
    copy_async16(stage + 4 * i, src + 4 * i);
  for (int i = 4 * vec + threadIdx.x; i < count; i += THREADS)
    copy_async4(stage + i, src + i);
}

// 2^v and 1/v from the special-function unit, one instruction each
// (relative error about 2^-22; subnormal results flush to zero).
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// tanh v = 1 - 2 / (1 + e^2v); sigmoid v = 1 / (1 + e^-v).
__device__ __forceinline__ float tanh_fast(float v) {
  return fmaf(-2.f, rcp_approx(1.f + exp2_approx(2.88539008f * v)), 1.f);
}

__device__ __forceinline__ float sigmoid_fast(float v) {
  return rcp_approx(1.f + exp2_approx(-1.44269504f * v));
}

__device__ __forceinline__ float activate(int kind, float v) {
  if (kind == 0) return tanh_fast(v);
  if (kind == 1) return sigmoid_fast(v);
  return sinf(v);
}

__device__ __forceinline__ float4 activate4(int kind, float4 o) {
  if (kind == 0)
    return make_float4(tanh_fast(o.x), tanh_fast(o.y), tanh_fast(o.z),
                       tanh_fast(o.w));
  if (kind == 1)
    return make_float4(sigmoid_fast(o.x), sigmoid_fast(o.y),
                       sigmoid_fast(o.z), sigmoid_fast(o.w));
  return o;
}

// Adds the bias b to the four points of one feature, applies the fused
// activation and stores them.
__device__ __forceinline__ void finish(float* dst, float4 o, float b,
                                       int act) {
  o.x += b;
  o.y += b;
  o.z += b;
  o.w += b;
  *reinterpret_cast<float4*>(dst) = activate4(act, o);
}

__device__ __forceinline__ void fma4(float4& acc, const float4& v, float w) {
  acc.x = fmaf(v.x, w, acc.x);
  acc.y = fmaf(v.y, w, acc.y);
  acc.z = fmaf(v.z, w, acc.z);
  acc.w = fmaf(v.w, w, acc.w);
}

// out[c][m] = act(sum_k in[k][m] * ws[k][c] + ws[K][c]) for c < N and the
// tile's points m; ws holds K + 1 rows of npad = 4 ceil(N / 4) floats.  A
// thread owns the points 4 rg .. 4 rg + 3 and the features 4 cg .. 4 cg + 3;
// the threads of a warp share cg, so the weights they load are one
// broadcast and the state they load is contiguous.  `act` is -1 (none),
// tanh or sigmoid: sin, whose slow path for large arguments would be copied
// 16 times here, runs as a pass of its own.
template <int TILE>
__device__ void dense(const float* in, float* out, int K, int N,
                      const float* ws, int act) {
  constexpr int LD = TILE + ROW_PAD;
  constexpr int RG = TILE / 4;
  const int npad = round4(N);
  for (int item = threadIdx.x; item < npad / 4 * RG; item += THREADS) {
    const int cg = item / RG, rg = item % RG;
    const float* a = in + 4 * rg;
    const float* wp = ws + 4 * cg;
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(a + k * LD);
      const float4 wv = *reinterpret_cast<const float4*>(wp + k * npad);
      fma4(acc[0], v, wv.x);
      fma4(acc[1], v, wv.y);
      fma4(acc[2], v, wv.z);
      fma4(acc[3], v, wv.w);
    }
    const float4 b = *reinterpret_cast<const float4*>(wp + K * npad);
    float* dst = out + 4 * cg * LD + 4 * rg;
    finish(dst, acc[0], b.x, act);
    if (4 * cg + 1 < N) finish(dst + LD, acc[1], b.y, act);
    if (4 * cg + 2 < N) finish(dst + 2 * LD, acc[2], b.z, act);
    if (4 * cg + 3 < N) finish(dst + 3 * LD, acc[3], b.w, act);
  }
}

template <int TILE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w_glob,
               const int* __restrict__ tab, float* __restrict__ out, int n,
               int out_dim, int P) {
  constexpr int LD = TILE + ROW_PAD;
  w_glob += (size_t)blockIdx.y * P;
  out += (size_t)blockIdx.y * n * out_dim;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const Plan p = read_plan(tab);
  float* stage = ws + p.staged;
  float* planes = stage + round4(TILE * p.in_dim);
  const int plane = p.wmax * LD;
  float* stack = planes + 2 * plane;
  const int tiles = (n + TILE - 1) / TILE;

  stage_weights(p, ws, w_glob);
  if ((int)blockIdx.x < tiles) fetch_points<TILE>(p, stage, x, n, blockIdx.x);
  commit_copies();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    wait_copies();
    __syncthreads();
    float* cur = planes;
    float* nxt = planes + plane;
    // The tile's input state; padded points get x = 0.
    const int valid = min(TILE, n - t * TILE);
    for (int i = threadIdx.x; i < TILE * p.in_dim; i += THREADS) {
      const int k = i / TILE, m = i % TILE;
      cur[k * LD + m] = m < valid ? stage[m * p.in_dim + k] : 0.f;
    }
    __syncthreads();
    if (t + (int)gridDim.x < tiles)
      fetch_points<TILE>(p, stage, x, n, t + gridDim.x);
    commit_copies();
    int width = p.in_dim, depth = 0;
    for (int o = 0; o < p.n_ops; ++o) {
      const int* op = p.ops + o * OP_INTS;
      const int kind = op[0];
      if (kind == 0) {
        dense<TILE>(cur, nxt, op[1], op[2], ws + op[4], op[5]);
        float* swap = cur;
        cur = nxt;
        nxt = swap;
        width = op[2];
      } else if (kind == 1) {
        for (int i = threadIdx.x; i < width * TILE; i += THREADS) {
          float* v = cur + (i / TILE) * LD + i % TILE;
          *v = activate(op[2], *v);
        }
      } else if (kind == 2) {
        float* slot = stack + depth * plane;
        for (int i = threadIdx.x; i < width * TILE; i += THREADS)
          slot[(i / TILE) * LD + i % TILE] = cur[(i / TILE) * LD + i % TILE];
        ++depth;
      } else {
        --depth;
        const float* slot = stack + depth * plane;
        for (int i = threadIdx.x; i < width * TILE; i += THREADS)
          cur[(i / TILE) * LD + i % TILE] += slot[(i / TILE) * LD + i % TILE];
      }
      __syncthreads();
    }
    float* dst = out + (size_t)t * TILE * out_dim;
    for (int i = threadIdx.x; i < TILE * out_dim; i += THREADS) {
      const int j = i / TILE, m = i % TILE;
      if (m < valid) dst[m * out_dim + j] = cur[j * LD + m];
    }
  }
  wait_copies();
}

}  // namespace

// ---- launch code ----------------------------------------------------------

namespace {

template <int TILE>
cudaError_t launch(const float* x, const float* w, const int* tab, float* out,
                   int n, int out_dim, int P, size_t smem, int grid,
                   int members, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_fwd_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  mlp_fwd_kernel<TILE><<<dim3(grid, members), THREADS, smem, stream>>>(
      x, w, tab, out, n, out_dim, P);
  return cudaGetLastError();
}

template <int TILE>
int blocks_per_sm(size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_fwd_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return -(int)err;
  }
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, mlp_fwd_kernel<TILE>, THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

extern "C" {

// How many blocks of the kernel at this tile and shared memory one SM holds
// at once (a negative CUDA error code on failure).
int pdt_mlp_blocks_per_sm(int staged, int in_dim, int wmax, int max_stack,
                          int tile) {
  const size_t smem =
      sizeof(float) * mlp_smem_floats(staged, in_dim, wmax, max_stack, tile);
  if (tile == 128) return blocks_per_sm<128>(smem);
  if (tile == 64) return blocks_per_sm<64>(smem);
  if (tile == 32) return blocks_per_sm<32>(smem);
  return -(int)cudaErrorInvalidValue;
}

// x (n, in_dim), w (members, P packed weights), tab (device op table), out
// (members, n, out_dim); `grid` persistent blocks of `tile` points a member.
int pdt_mlp_forward(const float* x, const float* w, const int* tab,
                    float* out, int n, int staged, int in_dim, int wmax,
                    int max_stack, int tile, int out_dim, int P, int grid,
                    int members, void* stream) {
  const size_t smem =
      sizeof(float) * mlp_smem_floats(staged, in_dim, wmax, max_stack, tile);
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile == 128)
    return (int)launch<128>(x, w, tab, out, n, out_dim, P, smem, grid,
                            members, s);
  if (tile == 64)
    return (int)launch<64>(x, w, tab, out, n, out_dim, P, smem, grid,
                            members, s);
  if (tile == 32)
    return (int)launch<32>(x, w, tab, out, n, out_dim, P, smem, grid,
                            members, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
