// Fused forward of a layout-string MLP chain (tokens f, c, a, R, +).
//
// Replaces the Pallas kernel of pydens_tpu/ops/pallas_mlp.py built by
// make_fused_mlp_forward (`fused_apply`, body `kernel`): a batch-tiled
// forward with the weights resident on-chip and the activations, skip stack
// included, never leaving it.
//
// What bounds it on an H100: at the README predict call (10,000 points,
// widths 10/12/15/1) a launch costs its latency.  At large n each thread
// walks sum(K*N) dependent FMAs on shared-memory operands against 4 *
// (in_dim + out_dim) bytes of device memory per point, so it is bound by
// that per-thread latency, hidden only as far as occupancy allows (no
// tensor cores: TF32 would break the f32 precision policy).
//
// Design: one thread per point, POINTS_PER_BLOCK points per block; the
// packed weights, two state buffers and the skip stack live in shared
// memory, laid out [feature][point] so a warp touches consecutive words.
// Each thread works in its own column, so the only barrier is the one
// after the weights are staged.
//
// Op table (int32, built by pydens_tpu_torch/ops/fused_mlp.py):
//   [0] n_ops [1] in_dim [2] wmax [3] max_stack
//   then n_ops records of OP_INTS ints:
//     dense: 0, K, N, w_off, b_off
//     act:   1, width, act_kind (0 tanh, 1 sigmoid, 2 sin), 0, 0
//     push:  2, width, 0, 0, 0        ('R')
//     add:   3, width, 0, 0, 0        ('+')

#include <cuda_runtime.h>

namespace {

constexpr int POINTS_PER_BLOCK = 64;
constexpr int OP_INTS = 5;
constexpr int HEADER_INTS = 4;

__device__ __forceinline__ float sigma(int kind, float v) {
  if (kind == 0) return tanhf(v);
  if (kind == 1) return 1.f / (1.f + expf(-v));
  return sinf(v);
}

__global__ void mlp_fwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ w_glob,
                               const int* __restrict__ tab,
                               float* __restrict__ out, int n, int P,
                               int out_dim) {
  extern __shared__ float smem[];
  const int n_ops = tab[0], in_dim = tab[1], wmax = tab[2];
  const int* ops = tab + HEADER_INTS;
  const int plane = wmax * POINTS_PER_BLOCK;
  float* w = smem;
  float* cur = smem + P;
  float* nxt = cur + plane;
  float* stack = nxt + plane;
  for (int i = threadIdx.x; i < P; i += blockDim.x) w[i] = w_glob[i];
  __syncthreads();

  const int lane = threadIdx.x;
  const int row = blockIdx.x * POINTS_PER_BLOCK + lane;
  if (row >= n) return;
#define COL(buf, k) (buf)[(k) * POINTS_PER_BLOCK + lane]
  for (int k = 0; k < in_dim; ++k) COL(cur, k) = x[(size_t)row * in_dim + k];
  int depth = 0;
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + o * OP_INTS;
    const int kind = op[0];
    if (kind == 0) {
      const int K = op[1], N = op[2];
      const float* wm = w + op[3];
      const float* bias = w + op[4];
      for (int j = 0; j < N; ++j) {
        float acc = 0.f;
        for (int k = 0; k < K; ++k) acc = fmaf(COL(cur, k), wm[k * N + j], acc);
        COL(nxt, j) = acc + bias[j];
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
    } else if (kind == 1) {
      for (int j = 0; j < op[1]; ++j) COL(cur, j) = sigma(op[2], COL(cur, j));
    } else if (kind == 2) {
      float* slot = stack + depth * plane;
      for (int j = 0; j < op[1]; ++j) COL(slot, j) = COL(cur, j);
      ++depth;
    } else {
      --depth;
      const float* slot = stack + depth * plane;
      for (int j = 0; j < op[1]; ++j) COL(cur, j) += COL(slot, j);
    }
  }
  for (int j = 0; j < out_dim; ++j) out[(size_t)row * out_dim + j] = COL(cur, j);
#undef COL
}

}  // namespace

extern "C" {

int pdt_mlp_points_per_block() { return POINTS_PER_BLOCK; }

// x (n, in_dim), w (P,), tab (device op table), out (n, out_dim).
int pdt_mlp_forward(const float* x, const float* w, const int* tab,
                    float* out, int n, int P, int wmax, int max_stack,
                    int out_dim, void* stream) {
  const int blocks = (n + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK;
  const size_t smem =
      sizeof(float) * ((size_t)P + (2 + (size_t)max_stack) * wmax * POINTS_PER_BLOCK);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mlp_fwd_kernel<<<blocks, POINTS_PER_BLOCK, smem, (cudaStream_t)stream>>>(
      x, w, tab, out, n, P, out_dim);
  return (int)cudaGetLastError();
}

}  // extern "C"
