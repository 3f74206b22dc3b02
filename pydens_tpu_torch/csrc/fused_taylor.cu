// Fused Taylor traversal of a dense f/c/a chain: forward and hand adjoint.
//
// Replaces the Pallas kernels of pydens_tpu/ops/pallas_taylor.py built by
// make_fused_taylor: `_pallas_fwd` (body `fwd_kernel`, `_forward_states`)
// and `_pallas_bwd` (body `bwd_kernel`, `_act_adjoint`).
//
// What it computes, per collocation point: the value stream V, the first-
// order streams T_d (one-hot start) and the second-order streams S_ab (zero
// start) of the network.  A dense layer applies W to every stream and adds
// the bias to V only; an activation maps V -> s(V), T_d -> s'T_d and
// S_ab -> s''T_aT_b + s'S_ab.  The backward is the adjoint of that
// recurrence; it needs s''' and the per-layer input states.
//
// What bounds it on an H100: latency, not FMAs or bytes.  One thread walks
// its point's whole traversal serially — S * sum(K*N) dependent FMAs on
// shared-memory operands, ~2k for the README chain — so at n = 100 a launch
// takes tens of microseconds while almost all of the card idles.  At a
// 64-wide chain the two state buffers (2 * S * 64 * POINTS_PER_BLOCK
// floats) leave room for one block per SM, so large n stays latency-bound
// too.  The backward adds the saved-state traffic to device memory (S *
// sum of op input widths floats per point, written once, read twice) and
// the per-block partial-gradient writes.  Spreading one point's work over
// several threads (one per output feature) is the next step for speed.
//
// Design: one thread per collocation point, POINTS_PER_BLOCK points per
// block.  The packed weights and two stream-state buffers live in shared
// memory, laid out [stream][feature][point] so a warp touches consecutive
// words.  The forward keeps each point in its own column and needs no
// synchronisation.  The backward recomputes the forward, keeping every
// layer's input state in a wrapper-allocated scratch buffer in device
// memory, then walks the ops in reverse.  The TPU kernel accumulated dW and
// db across its sequential grid; blocks here run in no order, so each block
// writes its own partial dW/db and a second launch sums the partials over
// blocks in a fixed order.  No atomics: gradients are bitwise reproducible.
//
// Op table (int32, built by pydens_tpu_torch/ops/fused_taylor.py):
//   [0] n_ops [1] in_dim [2] n_first [3] n_pairs [4] wmax
//   then n_first input columns (the T streams' directions),
//   then n_pairs (ia, ib) pairs of T-stream indices (the S streams),
//   then n_ops records of OP_INTS ints:
//     dense: 0, K, N, w_off, b_off, save_off
//     act:   1, width, act_kind (0 tanh, 1 sigmoid, 2 sin), 0, 0, save_off
//   save_off counts rows of the scratch buffer (one row per stream and
//   feature of the op's input state, n_pad floats each).

#include <cuda_runtime.h>

namespace {

constexpr int POINTS_PER_BLOCK = 32;
constexpr int OP_INTS = 6;
constexpr int HEADER_INTS = 5;

struct Plan {
  int n_ops, in_dim, n_first, n_pairs, wmax, n_streams;
  const int* first;
  const int* pairs;
  const int* ops;
};

__device__ Plan read_plan(const int* tab) {
  Plan p;
  p.n_ops = tab[0];
  p.in_dim = tab[1];
  p.n_first = tab[2];
  p.n_pairs = tab[3];
  p.wmax = tab[4];
  p.n_streams = 1 + p.n_first + p.n_pairs;
  p.first = tab + HEADER_INTS;
  p.pairs = p.first + p.n_first;
  p.ops = p.pairs + 2 * p.n_pairs;
  return p;
}

// s, s', s'', s''' in closed form.
__device__ __forceinline__ void sigma_derivs(int kind, float v, float* d) {
  if (kind == 0) {
    const float t = tanhf(v);
    const float d1 = 1.f - t * t;
    d[0] = t;
    d[1] = d1;
    d[2] = -2.f * t * d1;
    d[3] = -2.f * d1 * (d1 - 2.f * t * t);
  } else if (kind == 1) {
    const float s = 1.f / (1.f + expf(-v));
    const float d1 = s * (1.f - s);
    const float u = 1.f - 2.f * s;
    d[0] = s;
    d[1] = d1;
    d[2] = d1 * u;
    d[3] = d1 * (u * u - 2.f * d1);
  } else {
    float s, c;
    sincosf(v, &s, &c);
    d[0] = s;
    d[1] = c;
    d[2] = -s;
    d[3] = -c;
  }
}

// Element (stream s, feature k) of this thread's column in a state buffer.
__device__ __forceinline__ float& st(float* buf, int wmax, int s, int k) {
  return buf[(s * wmax + k) * POINTS_PER_BLOCK + threadIdx.x];
}

// Runs the traversal for this thread's point; returns the buffer holding the
// final state.  With `scratch`, every op's input state is stored there.
__device__ float* forward_column(const Plan& p, const float* w,
                                 const float* __restrict__ x, int n, int row,
                                 float* a, float* b, float* scratch,
                                 int n_pad) {
  const int W = p.wmax;
  const int S = p.n_streams;
  const int F = p.n_first;
  const bool valid = row < n;
  for (int k = 0; k < p.in_dim; ++k) {
    st(a, W, 0, k) = valid ? x[(size_t)row * p.in_dim + k] : 0.f;
    for (int i = 0; i < F; ++i) st(a, W, 1 + i, k) = (k == p.first[i]) ? 1.f : 0.f;
    for (int q = 0; q < p.n_pairs; ++q) st(a, W, 1 + F + q, k) = 0.f;
  }
  float* cur = a;
  float* nxt = b;
  int width = p.in_dim;
  for (int o = 0; o < p.n_ops; ++o) {
    const int* op = p.ops + o * OP_INTS;
    if (scratch != nullptr) {
      float* dst = scratch + (size_t)op[5] * n_pad + row;
      for (int s = 0; s < S; ++s)
        for (int k = 0; k < width; ++k)
          dst[(size_t)(s * width + k) * n_pad] = st(cur, W, s, k);
    }
    if (op[0] == 0) {
      const int K = op[1], N = op[2];
      const float* wm = w + op[3];
      const float* bias = w + op[4];
      for (int s = 0; s < S; ++s) {
        for (int j = 0; j < N; ++j) {
          float acc = 0.f;
          for (int k = 0; k < K; ++k) acc = fmaf(st(cur, W, s, k), wm[k * N + j], acc);
          st(nxt, W, s, j) = (s == 0) ? acc + bias[j] : acc;
        }
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
      width = N;
    } else {
      const int kind = op[2];
      for (int j = 0; j < width; ++j) {
        float d[4];
        sigma_derivs(kind, st(cur, W, 0, j), d);
        for (int q = 0; q < p.n_pairs; ++q) {
          const float ta = st(cur, W, 1 + p.pairs[2 * q], j);
          const float tb = st(cur, W, 1 + p.pairs[2 * q + 1], j);
          st(cur, W, 1 + F + q, j) = d[2] * ta * tb + d[1] * st(cur, W, 1 + F + q, j);
        }
        for (int i = 0; i < F; ++i) st(cur, W, 1 + i, j) *= d[1];
        st(cur, W, 0, j) = d[0];
      }
    }
  }
  return cur;
}

__device__ void load_weights(float* dst, const float* __restrict__ src, int P) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) dst[i] = src[i];
}

__global__ void taylor_fwd_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w_glob,
                                  const int* __restrict__ tab,
                                  float* __restrict__ out, int n, int P,
                                  int out_dim) {
  extern __shared__ float smem[];
  const Plan p = read_plan(tab);
  const int state = p.n_streams * p.wmax * POINTS_PER_BLOCK;
  float* w = smem;
  float* a = smem + P;
  float* b = a + state;
  load_weights(w, w_glob, P);
  __syncthreads();
  const int row = blockIdx.x * POINTS_PER_BLOCK + threadIdx.x;
  float* fin = forward_column(p, w, x, n, row, a, b, nullptr, 0);
  if (row >= n) return;
  const int cols = p.n_streams * out_dim;
  for (int s = 0; s < p.n_streams; ++s)
    for (int j = 0; j < out_dim; ++j)
      out[(size_t)row * cols + s * out_dim + j] = st(fin, p.wmax, s, j);
}

__global__ void taylor_bwd_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w_glob,
                                  const int* __restrict__ tab,
                                  const float* __restrict__ g,
                                  float* __restrict__ scratch,
                                  float* __restrict__ partials,
                                  float* __restrict__ dx, int n, int P,
                                  int out_dim) {
  extern __shared__ float smem[];
  const Plan p = read_plan(tab);
  const int W = p.wmax;
  const int S = p.n_streams;
  const int F = p.n_first;
  const int state = S * W * POINTS_PER_BLOCK;
  const int n_pad = gridDim.x * POINTS_PER_BLOCK;
  float* w = smem;
  float* a = smem + P;
  float* b = a + state;
  load_weights(w, w_glob, P);
  __syncthreads();
  const int row = blockIdx.x * POINTS_PER_BLOCK + threadIdx.x;
  const bool valid = row < n;
  forward_column(p, w, x, n, row, a, b, scratch, n_pad);

  // Cotangent of the output streams; padded rows carry zero, so they add
  // nothing to any gradient.
  const int cols = S * out_dim;
  float* G = a;
  float* Gn = b;
  for (int s = 0; s < S; ++s)
    for (int j = 0; j < out_dim; ++j)
      st(G, W, s, j) = valid ? g[(size_t)row * cols + s * out_dim + j] : 0.f;

  float* part = partials + (size_t)blockIdx.x * P;
  const size_t base = (size_t)blockIdx.x * POINTS_PER_BLOCK;
  for (int o = p.n_ops - 1; o >= 0; --o) {
    const int* op = p.ops + o * OP_INTS;
    const float* sv = scratch + (size_t)op[5] * n_pad;  // saved input state
    if (op[0] == 0) {
      const int K = op[1], N = op[2];
      const float* wm = w + op[3];
      // Every column of G (and of the saved input) is complete: the block's
      // partial dW[k][j] = sum over points and streams of X[s][k] * G[s][j].
      __syncthreads();
      for (int idx = threadIdx.x; idx < K * N; idx += blockDim.x) {
        const int k = idx / N, j = idx % N;
        float acc = 0.f;
        for (int s = 0; s < S; ++s) {
          const float* xs = sv + (size_t)(s * K + k) * n_pad + base;
          const float* gs = G + (s * W + j) * POINTS_PER_BLOCK;
          for (int q = 0; q < POINTS_PER_BLOCK; ++q) acc = fmaf(xs[q], gs[q], acc);
        }
        part[op[3] + idx] = acc;
      }
      for (int j = threadIdx.x; j < N; j += blockDim.x) {
        const float* gs = G + j * POINTS_PER_BLOCK;
        float acc = 0.f;
        for (int q = 0; q < POINTS_PER_BLOCK; ++q) acc += gs[q];
        part[op[4] + j] = acc;
      }
      // Own column: G_in[s][k] = sum_j G[s][j] * W[k][j].
      for (int s = 0; s < S; ++s) {
        for (int k = 0; k < K; ++k) {
          float acc = 0.f;
          for (int j = 0; j < N; ++j) acc = fmaf(st(G, W, s, j), wm[k * N + j], acc);
          st(Gn, W, s, k) = acc;
        }
      }
      float* t = G;
      G = Gn;
      Gn = t;
    } else {
      const int width = op[1], kind = op[2];
      const float* sr = sv + row;
      for (int j = 0; j < width; ++j) {
        float d[4];
        sigma_derivs(kind, sr[(size_t)j * n_pad], d);
        float gv = st(G, W, 0, j) * d[1];
        for (int i = 0; i < F; ++i)
          gv += st(G, W, 1 + i, j) * d[2] * sr[(size_t)((1 + i) * width + j) * n_pad];
        for (int q = 0; q < p.n_pairs; ++q) {
          const int ia = p.pairs[2 * q], ib = p.pairs[2 * q + 1];
          const float ta = sr[(size_t)((1 + ia) * width + j) * n_pad];
          const float tb = sr[(size_t)((1 + ib) * width + j) * n_pad];
          const float s0 = sr[(size_t)((1 + F + q) * width + j) * n_pad];
          gv += st(G, W, 1 + F + q, j) * (d[3] * ta * tb + d[2] * s0);
        }
        for (int i = 0; i < F; ++i) {
          float gt = st(G, W, 1 + i, j) * d[1];
          for (int q = 0; q < p.n_pairs; ++q) {
            const int ia = p.pairs[2 * q], ib = p.pairs[2 * q + 1];
            const float gs = st(G, W, 1 + F + q, j) * d[2];
            if (ia == i) gt += gs * sr[(size_t)((1 + ib) * width + j) * n_pad];
            if (ib == i) gt += gs * sr[(size_t)((1 + ia) * width + j) * n_pad];
          }
          st(G, W, 1 + i, j) = gt;
        }
        for (int q = 0; q < p.n_pairs; ++q) st(G, W, 1 + F + q, j) *= d[1];
        st(G, W, 0, j) = gv;
      }
    }
  }
  if (valid)
    for (int k = 0; k < p.in_dim; ++k) dx[(size_t)row * p.in_dim + k] = st(G, W, 0, k);
}

// Sums the per-block partial gradients over blocks, in block order.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int n_blocks,
                                       int P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float acc = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) acc += partials[(size_t)blk * P + i];
  out[i] = acc;
}

size_t taylor_smem_bytes(int P, int n_streams, int wmax) {
  return sizeof(float) * ((size_t)P + 2 * (size_t)n_streams * wmax * POINTS_PER_BLOCK);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

int pdt_taylor_points_per_block() { return POINTS_PER_BLOCK; }

// x (n, in_dim), w (P,), tab (device op table), out (n, n_streams*out_dim).
int pdt_taylor_forward(const float* x, const float* w, const int* tab,
                       float* out, int n, int P, int n_streams, int wmax,
                       int out_dim, void* stream) {
  const int blocks = (n + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK;
  const size_t smem = taylor_smem_bytes(P, n_streams, wmax);
  cudaError_t err = allow_smem((const void*)taylor_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  taylor_fwd_kernel<<<blocks, POINTS_PER_BLOCK, smem, (cudaStream_t)stream>>>(
      x, w, tab, out, n, P, out_dim);
  return (int)cudaGetLastError();
}

// g (n, n_streams*out_dim); scratch (n_save_rows * n_pad); partials
// (blocks * P); dw (P,); dx (n, in_dim).  n_pad = blocks * points per block.
int pdt_taylor_backward(const float* x, const float* w, const int* tab,
                        const float* g, float* scratch, float* partials,
                        float* dw, float* dx, int n, int P, int n_streams,
                        int wmax, int out_dim, void* stream) {
  const int blocks = (n + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK;
  const size_t smem = taylor_smem_bytes(P, n_streams, wmax);
  cudaError_t err = allow_smem((const void*)taylor_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  taylor_bwd_kernel<<<blocks, POINTS_PER_BLOCK, smem, (cudaStream_t)stream>>>(
      x, w, tab, g, scratch, partials, dx, n, P, out_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(P + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partials, dw, blocks, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
