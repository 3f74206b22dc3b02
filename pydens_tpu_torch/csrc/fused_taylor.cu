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
// recurrence; it needs s''' and the input state of each activation.
//
// What bounds it on an H100: latency and occupancy, not FMAs or bytes.  At
// a 64-wide chain and 65,537 points the forward is 2.75 G FMAs and the
// backward about three times that: 0.1 and 0.3 ms at the card's f32 FMA
// rate, and only a few bytes per point cross device memory.
//
// The first design (one thread walked its point's whole traversal, 32
// points per block, two stream-state buffers per block, every op's input
// state saved to device memory for the backward) took, on an NVIDIA H100
// 80GB HBM3 at 700 W, 6.90 ms forward and 44.52 ms backward at that shape
// (plain PyTorch: 1.48 and 5.32 ms), and 0.052 / 0.195 ms on the README
// chain at 100 points.  Its serial per-thread FMA chains and one 32-thread
// block per SM left the card idle, and the backward wrote S * (sum of op
// input widths) floats per point to device memory (2.3 GB at 262,144
// points).
//
// This design:
// * A tile of TILE_POINTS points is the unit of work, and THREADS threads
//   work on it together.  The state of a tile lives in shared memory as
//   [feature][row] with row = stream * TILE_POINTS + point, so a dense
//   layer is the product (S*M x K) . (K x N).  Each thread owns a register
//   tile of 4 rows x 4 output features (features strided by ceil(N/4)) and
//   accumulates over K with one 16-byte shared load of the state and four
//   broadcast weight loads per 16 FMAs.  The activation step is elementwise
//   over (feature, point).
// * Register-tiled f32 FMA, no tensor cores: the tolerances (values 2e-5,
//   gradients 2e-3 relative) rule out plain TF32, and by the arithmetic
//   above FMA leaves the product far from being the bound, so the
//   error-compensated 3xTF32 route was not taken.
// * Persistent blocks: the wrapper launches at most MIN_BLOCKS_PER_SM
//   blocks per SM (as shared memory allows); each copies the packed weights
//   into shared memory once with cp.async and walks the tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ...
// * The backward recomputes the forward per tile, keeping in a per-block
//   slab only the input state of each activation (and of a dense layer fed
//   by another dense layer); a dense layer's input is that activation
//   applied again.  The slab and the partial gradients are sized by the
//   grid, not by n (about 25 MB at the 64-wide chain, resident in L2).
// * Each block sums dW, db over its tiles in its fixed tile order into its
//   own partial (every element owned by one thread); a second launch sums
//   the partials in block order.  No atomics: the gradient is bitwise
//   repeatable.
//
// Op table (int32, built by pydens_tpu_torch/ops/fused_taylor.py):
//   [0] n_ops [1] in_dim [2] n_first [3] n_pairs [4] wmax [5] save_rows
//   then n_first input columns (the T streams' directions),
//   then n_pairs (ia, ib) pairs of T-stream indices (the S streams),
//   then n_ops records of OP_INTS ints:
//     dense: 0, K, N, w_off, b_off, save_off
//     act:   1, width, act_kind (0 tanh, 1 sigmoid, 2 sin), 0, 0, save_off
//   save_off counts rows of the backward's per-block slab (one row per
//   stream and feature of the op's input state, TILE_POINTS floats each),
//   or is -1 where the backward does not keep the op's input.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_POINTS = 16;
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS_PER_SM = 2;
constexpr int ROW_PAD = 4;  // row stride = rows + 4: 16-byte aligned, and
                            // (stride / 4) odd spreads strided float4 loads
constexpr int OP_INTS = 6;
constexpr int HEADER_INTS = 6;

struct Plan {
  int n_ops, in_dim, n_first, n_pairs, wmax, save_rows, n_streams;
  int rows;  // n_streams * TILE_POINTS
  int ld;    // row stride of a state buffer in shared memory
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
  p.save_rows = tab[5];
  p.n_streams = 1 + p.n_first + p.n_pairs;
  p.rows = p.n_streams * TILE_POINTS;
  p.ld = p.rows + ROW_PAD;
  p.first = tab + HEADER_INTS;
  p.pairs = p.first + p.n_first;
  p.ops = p.pairs + 2 * p.n_pairs;
  return p;
}

__host__ __device__ int weights_floats(int P) { return (P + 3) & ~3; }

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

// Starts the copy of the packed weights into shared memory; wait_weights()
// then __syncthreads() completes it.
__device__ void load_weights_async(float* dst, const float* src, int P) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < P; i += THREADS)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(base + 4u * i),
                 "l"(src + i));
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_weights() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The tile's input state: V = x, T_d = e_d, S = 0; padded points get x = 0.
__device__ void init_state(const Plan& p, float* buf,
                           const float* __restrict__ x, int n, int tile) {
  for (int idx = threadIdx.x; idx < p.in_dim * p.rows; idx += THREADS) {
    const int k = idx / p.rows, r = idx - k * p.rows;
    const int s = r / TILE_POINTS;
    const int row = tile * TILE_POINTS + (r - s * TILE_POINTS);
    float v = 0.f;
    if (s == 0) {
      if (row < n) v = x[(size_t)row * p.in_dim + k];
    } else if (s <= p.n_first) {
      v = (k == p.first[s - 1]) ? 1.f : 0.f;
    }
    buf[k * p.ld + r] = v;
  }
}

// The activation of features [0, width) of a state read from `src` (feature
// stride src_ld) into `dst` (feature stride dst_ld); src may be dst.  With
// `save`, the input state is copied there too (feature stride p.rows).
__device__ void act_columns(const Plan& p, int width, int kind,
                            const float* src, int src_ld, float* dst,
                            int dst_ld, float* save) {
  const int F = p.n_first;
  for (int idx = threadIdx.x; idx < width * TILE_POINTS; idx += THREADS) {
    const int j = idx / TILE_POINTS, m = idx - j * TILE_POINTS;
    const float* in = src + j * src_ld + m;
    float* out = dst + j * dst_ld + m;
    if (save != nullptr) {
      float* sv = save + j * p.rows + m;
      for (int s = 0; s < p.n_streams; ++s)
        sv[s * TILE_POINTS] = in[s * TILE_POINTS];
    }
    float d[4];
    sigma_derivs(kind, in[0], d);
    for (int q = 0; q < p.n_pairs; ++q) {
      const float ta = in[(1 + p.pairs[2 * q]) * TILE_POINTS];
      const float tb = in[(1 + p.pairs[2 * q + 1]) * TILE_POINTS];
      const int o = (1 + F + q) * TILE_POINTS;
      out[o] = fmaf(d[2] * ta, tb, d[1] * in[o]);
    }
    for (int i = 0; i < F; ++i)
      out[(1 + i) * TILE_POINTS] = d[1] * in[(1 + i) * TILE_POINTS];
    out[0] = d[0];
  }
}

// out[c][r] = sum_{t < T} in[t][r] * wm[c * cs + t * ts] for c < C and
// r < rows, plus bias[c] on the V rows when `bias` is given.  A thread owns
// rows r0..r0+3 and the columns cg, cg + ncg, cg + 2 ncg, cg + 3 ncg.
__device__ void product(const float* in, float* out, int ld, int rows, int T,
                        int C, const float* wm, int cs, int ts,
                        const float* bias) {
  const int nrg = rows / 4, ncg = (C + 3) / 4;
  for (int item = threadIdx.x; item < nrg * ncg; item += THREADS) {
    const int cg = item / nrg, r0 = 4 * (item - cg * nrg);
    const float* wp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wp[i] = wm + min(cg + i * ncg, C - 1) * cs;
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* a = in + r0;
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(a + t * ld);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wv = wp[i][t * ts];
        acc[i].x = fmaf(v.x, wv, acc[i].x);
        acc[i].y = fmaf(v.y, wv, acc[i].y);
        acc[i].z = fmaf(v.z, wv, acc[i].z);
        acc[i].w = fmaf(v.w, wv, acc[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = cg + i * ncg;
      if (c >= C) continue;
      float4 o = acc[i];
      if (bias != nullptr && r0 < TILE_POINTS) {
        const float b = bias[c];
        o.x += b;
        o.y += b;
        o.z += b;
        o.w += b;
      }
      *reinterpret_cast<float4*>(out + c * ld + r0) = o;
    }
  }
}

// This tile's share of a dense layer's parameter gradient, added to the
// block's partial (written at its first tile): dw[k][j] += sum_r X[k][r] *
// G[j][r] over all rows, db[j] += sum over the V rows of G[j][r].  A thread
// owns the same 4 x 4 elements at every tile, so each element is summed in
// one fixed order.
__device__ void param_grad(const float* X, const float* G, int ld, int rows,
                           int K, int N, float* dw, float* db, bool first) {
  const int nkg = (K + 3) / 4, njg = (N + 3) / 4;
  for (int item = threadIdx.x; item < nkg * njg; item += THREADS) {
    const int kg = item / njg, jg = item - kg * njg;
    const float* xp[4];
    const float* gp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xp[i] = X + min(kg + i * nkg, K - 1) * ld;
      gp[i] = G + min(jg + i * njg, N - 1) * ld;
    }
    float acc[4][4] = {};
    for (int r = 0; r < rows; r += 4) {
      float4 xv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = *reinterpret_cast<const float4*>(xp[i] + r);
        gv[i] = *reinterpret_cast<const float4*>(gp[i] + r);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          acc[i][l] = fmaf(xv[i].x, gv[l].x, acc[i][l]);
          acc[i][l] = fmaf(xv[i].y, gv[l].y, acc[i][l]);
          acc[i][l] = fmaf(xv[i].z, gv[l].z, acc[i][l]);
          acc[i][l] = fmaf(xv[i].w, gv[l].w, acc[i][l]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int k = kg + i * nkg, j = jg + l * njg;
        if (k < K && j < N) {
          float* d = dw + k * N + j;
          *d = first ? acc[i][l] : *d + acc[i][l];
        }
      }
  }
  for (int j = threadIdx.x; j < N; j += THREADS) {
    const float* gs = G + j * ld;
    float acc = 0.f;
    for (int m = 0; m < TILE_POINTS; ++m) acc += gs[m];
    db[j] = first ? acc : db[j] + acc;
  }
}

// Copies features [0, width) of a state between shared memory (stride
// p.ld) and the slab (stride p.rows).
__device__ void save_state(const Plan& p, const float* buf, int width,
                           float* save) {
  for (int idx = threadIdx.x; idx < width * p.rows; idx += THREADS) {
    const int j = idx / p.rows, r = idx - j * p.rows;
    save[idx] = buf[j * p.ld + r];
  }
}

__device__ void load_state(const Plan& p, const float* save, int width,
                           float* buf) {
  for (int idx = threadIdx.x; idx < width * p.rows; idx += THREADS) {
    const int j = idx / p.rows, r = idx - j * p.rows;
    buf[j * p.ld + r] = save[idx];
  }
}

// The adjoint of act_columns, in place on the cotangent G, from the saved
// input state `sv` (feature stride p.rows).
__device__ void act_adjoint(const Plan& p, int width, int kind,
                            const float* sv, float* G) {
  const int F = p.n_first;
  for (int idx = threadIdx.x; idx < width * TILE_POINTS; idx += THREADS) {
    const int j = idx / TILE_POINTS, m = idx - j * TILE_POINTS;
    const float* in = sv + j * p.rows + m;
    float* g = G + j * p.ld + m;
    float d[4];
    sigma_derivs(kind, in[0], d);
    float gv = g[0] * d[1];
    for (int i = 0; i < F; ++i)
      gv += g[(1 + i) * TILE_POINTS] * d[2] * in[(1 + i) * TILE_POINTS];
    for (int q = 0; q < p.n_pairs; ++q) {
      const float ta = in[(1 + p.pairs[2 * q]) * TILE_POINTS];
      const float tb = in[(1 + p.pairs[2 * q + 1]) * TILE_POINTS];
      const float s0 = in[(1 + F + q) * TILE_POINTS];
      gv += g[(1 + F + q) * TILE_POINTS] * (d[3] * ta * tb + d[2] * s0);
    }
    for (int i = 0; i < F; ++i) {
      float gt = g[(1 + i) * TILE_POINTS] * d[1];
      for (int q = 0; q < p.n_pairs; ++q) {
        const int ia = p.pairs[2 * q], ib = p.pairs[2 * q + 1];
        const float gs = g[(1 + F + q) * TILE_POINTS] * d[2];
        if (ia == i) gt += gs * in[(1 + ib) * TILE_POINTS];
        if (ib == i) gt += gs * in[(1 + ia) * TILE_POINTS];
      }
      g[(1 + i) * TILE_POINTS] = gt;
    }
    for (int q = 0; q < p.n_pairs; ++q) g[(1 + F + q) * TILE_POINTS] *= d[1];
    g[0] = gv;
  }
}

// Element (point m, column c) of the (n, S * out_dim) stream matrix, for
// the tile's points, lies at feature c % out_dim, row (c / out_dim) * M + m.
__device__ void store_streams(const Plan& p, const float* buf,
                              float* __restrict__ out, int n, int tile,
                              int out_dim) {
  const int cols = p.n_streams * out_dim;
  for (int idx = threadIdx.x; idx < TILE_POINTS * cols; idx += THREADS) {
    const int m = idx / cols, c = idx - m * cols;
    const int s = c / out_dim, j = c - s * out_dim;
    const int row = tile * TILE_POINTS + m;
    if (row < n) out[(size_t)row * cols + c] = buf[j * p.ld + s * TILE_POINTS + m];
  }
}

// The cotangent of the tile's output streams; padded points carry zero, so
// they add nothing to any gradient.
__device__ void load_cotangent(const Plan& p, const float* __restrict__ g,
                               float* G, int n, int tile, int out_dim) {
  const int cols = p.n_streams * out_dim;
  for (int idx = threadIdx.x; idx < TILE_POINTS * cols; idx += THREADS) {
    const int m = idx / cols, c = idx - m * cols;
    const int s = c / out_dim, j = c - s * out_dim;
    const int row = tile * TILE_POINTS + m;
    G[j * p.ld + s * TILE_POINTS + m] = row < n ? g[(size_t)row * cols + c] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
taylor_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w_glob,
                  const int* __restrict__ tab, float* __restrict__ out, int n,
                  int P, int out_dim) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  const Plan p = read_plan(tab);
  float* buf[2];
  buf[0] = w + weights_floats(P);
  buf[1] = buf[0] + p.wmax * p.ld;
  load_weights_async(w, w_glob, P);
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    init_state(p, buf[0], x, n, tile);
    wait_weights();
    __syncthreads();
    int cur = 0, width = p.in_dim;
    for (int o = 0; o < p.n_ops; ++o) {
      const int* op = p.ops + o * OP_INTS;
      if (op[0] == 0) {
        product(buf[cur], buf[1 - cur], p.ld, p.rows, op[1], op[2], w + op[3],
                1, op[2], w + op[4]);
        cur = 1 - cur;
        width = op[2];
      } else {
        act_columns(p, width, op[2], buf[cur], p.ld, buf[cur], p.ld, nullptr);
      }
      __syncthreads();
    }
    store_streams(p, buf[cur], out, n, tile, out_dim);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
taylor_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w_glob,
                  const int* __restrict__ tab, const float* __restrict__ g,
                  float* __restrict__ saves, float* __restrict__ partials,
                  float* __restrict__ dx, int n, int P, int out_dim) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  const Plan p = read_plan(tab);
  float* buf[3];
  buf[0] = w + weights_floats(P);
  buf[1] = buf[0] + p.wmax * p.ld;
  buf[2] = buf[1] + p.wmax * p.ld;
  float* slab = saves + (size_t)blockIdx.x * p.save_rows * TILE_POINTS;
  float* part = partials + (size_t)blockIdx.x * P;
  load_weights_async(w, w_glob, P);
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    // Recompute the forward, keeping what the adjoint reads.  The last op's
    // output is not needed.
    init_state(p, buf[0], x, n, tile);
    wait_weights();
    __syncthreads();
    int cur = 0, width = p.in_dim;
    for (int o = 0; o < p.n_ops; ++o) {
      const int* op = p.ops + o * OP_INTS;
      float* sv = op[5] >= 0 ? slab + op[5] * TILE_POINTS : nullptr;
      if (op[0] == 0) {
        if (sv != nullptr) save_state(p, buf[cur], width, sv);
        if (o + 1 < p.n_ops) {
          product(buf[cur], buf[1 - cur], p.ld, p.rows, op[1], op[2],
                  w + op[3], 1, op[2], w + op[4]);
          cur = 1 - cur;
          width = op[2];
        }
      } else {
        act_columns(p, width, op[2], buf[cur], p.ld, buf[cur], p.ld, sv);
      }
      __syncthreads();
    }

    float* G = buf[0];
    float* Gn = buf[1];
    float* X = buf[2];
    load_cotangent(p, g, G, n, tile, out_dim);
    __syncthreads();
    for (int o = p.n_ops - 1; o >= 0; --o) {
      const int* op = p.ops + o * OP_INTS;
      if (op[0] == 0) {
        const int K = op[1], N = op[2];
        // The layer's input: x, the previous activation applied again to
        // its saved input, or the saved output of the previous dense layer.
        if (o == 0) {
          init_state(p, X, x, n, tile);
        } else {
          const int* prev = op - OP_INTS;
          if (prev[0] == 1)
            act_columns(p, K, prev[2], slab + prev[5] * TILE_POINTS, p.rows, X,
                        p.ld, nullptr);
          else
            load_state(p, slab + op[5] * TILE_POINTS, K, X);
        }
        __syncthreads();
        param_grad(X, G, p.ld, p.rows, K, N, part + op[3], part + op[4], first);
        // G_in[k][r] = sum_j G[j][r] * W[k][j]; below the first layer only
        // the V rows (d x) are needed.
        product(G, Gn, p.ld, o == 0 ? TILE_POINTS : p.rows, N, K, w + op[3], N,
                1, nullptr);
        __syncthreads();
        float* t = G;
        G = Gn;
        Gn = t;
      } else {
        act_adjoint(p, op[1], op[2], slab + op[5] * TILE_POINTS, G);
        __syncthreads();
      }
    }
    for (int idx = threadIdx.x; idx < TILE_POINTS * p.in_dim; idx += THREADS) {
      const int m = idx / p.in_dim, k = idx - m * p.in_dim;
      const int row = tile * TILE_POINTS + m;
      if (row < n) dx[(size_t)row * p.in_dim + k] = G[k * p.ld + m];
    }
    __syncthreads();
  }
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

size_t taylor_smem_bytes(int P, int n_streams, int wmax, int n_bufs) {
  const size_t ld = (size_t)n_streams * TILE_POINTS + ROW_PAD;
  return sizeof(float) * ((size_t)weights_floats(P) + (size_t)n_bufs * wmax * ld);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

int pdt_taylor_tile_points() { return TILE_POINTS; }

// x (n, in_dim), w (P,), tab (device op table), out (n, n_streams*out_dim);
// `grid` persistent blocks.
int pdt_taylor_forward(const float* x, const float* w, const int* tab,
                       float* out, int n, int P, int n_streams, int wmax,
                       int out_dim, int grid, void* stream) {
  const size_t smem = taylor_smem_bytes(P, n_streams, wmax, 2);
  cudaError_t err = allow_smem((const void*)taylor_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  taylor_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, w, tab, out, n, P, out_dim);
  return (int)cudaGetLastError();
}

// g (n, n_streams*out_dim); saves (grid * save_rows * TILE_POINTS);
// partials (grid * P); dw (P,); dx (n, in_dim).  grid <= number of tiles.
int pdt_taylor_backward(const float* x, const float* w, const int* tab,
                        const float* g, float* saves, float* partials,
                        float* dw, float* dx, int n, int P, int n_streams,
                        int wmax, int out_dim, int grid, void* stream) {
  const size_t smem = taylor_smem_bytes(P, n_streams, wmax, 3);
  cudaError_t err = allow_smem((const void*)taylor_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  taylor_bwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, w, tab, g, saves, partials, dx, n, P, out_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(P + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partials, dw, grid, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
