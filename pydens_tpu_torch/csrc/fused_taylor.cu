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
// The start may instead be given whole, as an input state (n, n_streams,
// in_dim): an input embedding's value and Taylor streams (a periodic
// column's sin, cos and their derivatives, whose (x, x) taps are not 0),
// which the chain's first dense layer takes as it takes any state.  Every
// kernel has an instance that loads it (load_input_state, in place of
// init_state's one-hot start: the template flag INPUT_STATE) and is
// otherwise unchanged; the backward's then writes the whole state's
// cotangent, or none where no one asks for it.  The raw coordinates'
// instances compile as they did before the input state: the flag is a
// template argument, not a runtime branch, because a runtime one cost the
// backward 24 bytes of spills and lowered its share of its roofline in the
// 64-wide Adam cell from 13.91 to 13.70%, 1.5% (PERF.md section 6; NVIDIA
// H100 80GB HBM3, 700 W).
//
// A third kernel, taylor_jvp_kernel, has no Pallas counterpart: it is the
// tangent of the traversal with respect to the packed weights (the J.v of a
// Levenberg-Marquardt step, which the JAX package takes by XLA autodiff of
// its plan), the forward's recurrences on dual numbers.  It is reached as the
// backward of the backward: the VJP of g -> J^T g is J.v.  Its design (one
// fused dual product a layer, the weights streamed through a cp.async ring
// or, on small chains, resident; two blocks an SM at the 64-wide chain, any
// chain the backward takes) and
// its times are in the note above it, "The tangent kernel".
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
// * The backward reads, per tile, only the input state of each activation
//   (and of a dense layer fed by another dense layer); a dense layer's
//   input is that activation applied again.  It takes those states from
//   one of two places, fixed at compile time (taylor_bwd_kernel<FROM_STATES>):
//   - a forward's states: where autograd will run the backward of a
//     forward and the states take at most a quarter of the card's memory
//     (the wrapper's choice), that forward writes each tile's states to
//     device memory, laid out (members, tiles, save_rows, TILE_POINTS) so
//     that one tile's rows are contiguous (251 MB at the 64-wide chain and
//     65,536 points), and the backward runs no forward.  Every backward of that forward (a
//     Levenberg-Marquardt step's 51) reads the same states.
//   - recomputed: called without states, the backward replays the forward
//     per tile into a per-block slab of the same rows.  The slab and the
//     partial gradients are sized by the grid, not by n (about 25 MB at the
//     64-wide chain, resident in L2).
//   The states come from the same init_state / product / act_columns code
//   a tile at a time, so both paths give the same bits.  The adjoint stages
//   each state into a shared-memory tile buffer with cp.async (one round
//   trip for the whole state, where reading it in place took one for each
//   of a thread's items, twice), a dense layer's while the activation above
//   it runs its adjoint; the activation is applied out of place, so that
//   the staged input serves its adjoint too, and the product below it
//   then waits for param_grad (one more barrier).  On an NVIDIA H100 80GB
//   HBM3 at 700 W, at the 64-wide chain and 65,537 points: 1.18 ms from
//   the states (read in place: 1.32 ms, and 1.45 with an L2 prefetch of
//   the next tile's rows), 1.63 ms recomputing them (1.66 before the
//   staging); the forward keeping its states 0.49 ms against 0.44.
// * Each block sums dW, db over its tiles in its fixed tile order into its
//   own partial (every element owned by one thread); a second launch sums
//   the partials in block order.  No atomics: the gradient is bitwise
//   repeatable.
// * An ensemble (the Solver's n_models members, trained on shared points)
//   is the grid's second axis: block (b, k) runs member k, whose packed
//   weights start at k * P and whose outputs, cotangent, slab and partials
//   are member k's slices; the points are shared.  Each member has
//   gridDim.x persistent blocks (the wrapper gives max(1, slots / K),
//   capped by the tiles), every block stages its own member's weights, so
//   block size and shared memory stay as they are, and one launch fills the
//   SMs that a small chain's few tiles would leave idle.  With K = 1 the
//   grid is the single model's.
//
// Op table (int32, built by pydens_tpu_torch/ops/fused_taylor.py):
//   [0] n_ops [1] in_dim [2] n_first [3] n_pairs [4] wmax [5] save_rows
//   then n_first input columns (the T streams' directions),
//   then n_pairs (ia, ib) pairs of T-stream indices (the S streams),
//   then n_ops records of OP_INTS ints:
//     dense: 0, K, N, w_off, b_off, save_off
//     act:   1, width, act_kind (0 tanh, 1 sigmoid, 2 sin), 0, 0, save_off
//   save_off counts rows of a tile's saved states (one row per stream and
//   feature of the op's input state, TILE_POINTS floats each), or is -1
//   where the backward does not read the op's input.

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
  int rows;  // n_streams * points per tile
  int ld;    // row stride of a state buffer in shared memory
  const int* first;
  const int* pairs;
  const int* ops;
};

__device__ Plan read_plan(const int* tab, int tile = TILE_POINTS) {
  Plan p;
  p.n_ops = tab[0];
  p.in_dim = tab[1];
  p.n_first = tab[2];
  p.n_pairs = tab[3];
  p.wmax = tab[4];
  p.save_rows = tab[5];
  p.n_streams = 1 + p.n_first + p.n_pairs;
  p.rows = p.n_streams * tile;
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
template <int TP = TILE_POINTS>
__device__ void init_state(const Plan& p, float* buf,
                           const float* __restrict__ x, int n, int tile) {
  for (int idx = threadIdx.x; idx < p.in_dim * p.rows; idx += THREADS) {
    const int k = idx / p.rows, r = idx - k * p.rows;
    const int s = r / TP;
    const int row = tile * TP + (r - s * TP);
    float v = 0.f;
    if (s == 0) {
      if (row < n) v = x[(size_t)row * p.in_dim + k];
    } else if (s <= p.n_first) {
      v = (k == p.first[s - 1]) ? 1.f : 0.f;
    }
    buf[k * p.ld + r] = v;
  }
}

// The tile's input state given whole: `xs` (n, n_streams, in_dim), an
// embedding's Taylor state; padded points get 0 in every stream.
template <int TP = TILE_POINTS>
__device__ void load_input_state(const Plan& p, float* buf,
                                 const float* __restrict__ xs, int n,
                                 int tile) {
  for (int idx = threadIdx.x; idx < p.in_dim * p.rows; idx += THREADS) {
    const int k = idx / p.rows, r = idx - k * p.rows;
    const int s = r / TP;
    const int row = tile * TP + (r - s * TP);
    buf[k * p.ld + r] =
        row < n ? xs[((size_t)row * p.n_streams + s) * p.in_dim + k] : 0.f;
  }
}

// The tile's input state from x or, with INPUT_STATE, from xs.
template <bool INPUT_STATE, int TP = TILE_POINTS>
__device__ __forceinline__ void start_state(const Plan& p, float* buf,
                                            const float* __restrict__ x,
                                            const float* __restrict__ xs,
                                            int n, int tile) {
  if constexpr (INPUT_STATE)
    load_input_state<TP>(p, buf, xs, n, tile);
  else
    init_state<TP>(p, buf, x, n, tile);
}

// The activation of one (feature, point) column of a state, every stream
// (stride TP), from `in` into `out` (which may be `in`), with the
// derivatives `d` of s at V.
template <int TP = TILE_POINTS>
__device__ __forceinline__ void act_element(const Plan& p, const float* d,
                                            const float* in, float* out) {
  const int F = p.n_first;
  for (int q = 0; q < p.n_pairs; ++q) {
    const float ta = in[(1 + p.pairs[2 * q]) * TP];
    const float tb = in[(1 + p.pairs[2 * q + 1]) * TP];
    const int o = (1 + F + q) * TP;
    out[o] = fmaf(d[2] * ta, tb, d[1] * in[o]);
  }
  for (int i = 0; i < F; ++i) out[(1 + i) * TP] = d[1] * in[(1 + i) * TP];
  out[0] = d[0];
}

// The activation of features [0, width) of a state read from `src` into
// `dst` (feature stride p.ld each); src may be dst.  With `save`, the input
// state is copied there too (feature stride p.rows).
__device__ void act_columns(const Plan& p, int width, int kind,
                            const float* src, float* dst, float* save) {
  for (int idx = threadIdx.x; idx < width * TILE_POINTS; idx += THREADS) {
    const int j = idx / TILE_POINTS, m = idx - j * TILE_POINTS;
    const float* in = src + j * p.ld + m;
    float* out = dst + j * p.ld + m;
    if (save != nullptr) {
      float* sv = save + j * p.rows + m;
      for (int s = 0; s < p.n_streams; ++s)
        sv[s * TILE_POINTS] = in[s * TILE_POINTS];
    }
    float d[4];
    sigma_derivs(kind, in[0], d);
    act_element(p, d, in, out);
  }
}

// The activation on dual numbers, in place on the primal state `buf` and its
// tangent `tbuf` (feature stride p.ld): with a dot for the tangent,
//   V' = s'V.
//   T' = s''V.T + s'T.
//   S_ab' = s'''V.T_aT_b + s''(T_a.T_b + T_aT_b. + V.S_ab) + s'S_ab.
// then the primal update.  Each thread reads only its own column.
template <int TP>
__device__ void act_dual(const Plan& p, int width, int kind, float* buf,
                         float* tbuf) {
  const int F = p.n_first;
  for (int idx = threadIdx.x; idx < width * TP; idx += THREADS) {
    const int j = idx / TP, m = idx - j * TP;
    float* in = buf + j * p.ld + m;
    float* tin = tbuf + j * p.ld + m;
    float d[4];
    sigma_derivs(kind, in[0], d);
    const float vd = tin[0];
    for (int q = 0; q < p.n_pairs; ++q) {
      const int a = (1 + p.pairs[2 * q]) * TP;
      const int b = (1 + p.pairs[2 * q + 1]) * TP;
      const int o = (1 + F + q) * TP;
      const float mixed = tin[a] * in[b] + in[a] * tin[b] + vd * in[o];
      tin[o] = d[3] * vd * in[a] * in[b] + d[2] * mixed + d[1] * tin[o];
    }
    for (int i = 0; i < F; ++i) {
      const int t = (1 + i) * TP;
      tin[t] = d[2] * vd * in[t] + d[1] * tin[t];
    }
    tin[0] = d[1] * vd;
    act_element<TP>(p, d, in, in);
  }
}

// out[c][r] = sum_{t < T} in[t][r] * wm[c * cs + t * ts] for c < C and
// r < rows, plus bias[c] on the V rows when `bias` is given, plus what `out`
// held before with `accumulate`.  A thread owns rows r0..r0+3 and the
// columns cg, cg + ncg, cg + 2 ncg, cg + 3 ncg, the same in every call of
// the same (rows, C): a call that accumulates onto another's output needs no
// barrier between them.
__device__ void product(const float* in, float* out, int ld, int rows, int T,
                        int C, const float* wm, int cs, int ts,
                        const float* bias, bool accumulate = false) {
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
      float4* dst = reinterpret_cast<float4*>(out + c * ld + r0);
      if (accumulate) {
        const float4 prev = *dst;
        o.x += prev.x;
        o.y += prev.y;
        o.z += prev.z;
        o.w += prev.w;
      }
      *dst = o;
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

// Copies features [0, width) of a state from shared memory (stride p.ld)
// to saved rows (stride p.rows).
__device__ void save_state(const Plan& p, const float* buf, int width,
                           float* save) {
  for (int idx = threadIdx.x; idx < width * p.rows; idx += THREADS) {
    const int j = idx / p.rows, r = idx - j * p.rows;
    save[idx] = buf[j * p.ld + r];
  }
}

// The adjoint of act_columns, in place on the cotangent G, from the input
// state `sv` (feature stride p.ld).
__device__ void act_adjoint(const Plan& p, int width, int kind,
                            const float* sv, float* G) {
  const int F = p.n_first;
  for (int idx = threadIdx.x; idx < width * TILE_POINTS; idx += THREADS) {
    const int j = idx / TILE_POINTS, m = idx - j * TILE_POINTS;
    const float* in = sv + j * p.ld + m;
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
template <int TP = TILE_POINTS>
__device__ void store_streams(const Plan& p, const float* buf,
                              float* __restrict__ out, int n, int tile,
                              int out_dim) {
  const int cols = p.n_streams * out_dim;
  for (int idx = threadIdx.x; idx < TP * cols; idx += THREADS) {
    const int m = idx / cols, c = idx - m * cols;
    const int s = c / out_dim, j = c - s * out_dim;
    const int row = tile * TP + m;
    if (row < n) out[(size_t)row * cols + c] = buf[j * p.ld + s * TP + m];
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

// The input is the points x (n, in_dim), or with INPUT_STATE an embedding's
// Taylor state xs (n, n_streams, in_dim) and no x.  With `states` (members,
// tiles, save_rows, TILE_POINTS), each tile's rows of the states the
// backward reads are written there too (padded points as computed from x =
// 0, or from a zero state); without, nothing is.
template <bool INPUT_STATE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
taylor_fwd_kernel(const float* __restrict__ x, const float* __restrict__ xs,
                  const float* __restrict__ w_glob, const int* __restrict__ tab,
                  float* __restrict__ out, float* __restrict__ states, int n,
                  int P, int out_dim) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  const Plan p = read_plan(tab);
  const size_t member = blockIdx.y;
  w_glob += member * P;
  out += member * n * p.n_streams * out_dim;
  float* buf[2];
  buf[0] = w + weights_floats(P);
  buf[1] = buf[0] + p.wmax * p.ld;
  load_weights_async(w, w_glob, P);
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  const size_t tile_floats = (size_t)p.save_rows * TILE_POINTS;
  if (states != nullptr) states += member * tiles * tile_floats;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float* slab = states != nullptr ? states + tile * tile_floats : nullptr;
    start_state<INPUT_STATE>(p, buf[0], x, xs, n, tile);
    wait_weights();
    __syncthreads();
    int cur = 0, width = p.in_dim;
    for (int o = 0; o < p.n_ops; ++o) {
      const int* op = p.ops + o * OP_INTS;
      float* sv =
          slab != nullptr && op[5] >= 0 ? slab + op[5] * TILE_POINTS : nullptr;
      if (op[0] == 0) {
        if (sv != nullptr) save_state(p, buf[cur], width, sv);
        product(buf[cur], buf[1 - cur], p.ld, p.rows, op[1], op[2], w + op[3],
                1, op[2], w + op[4]);
        cur = 1 - cur;
        width = op[2];
      } else {
        act_columns(p, width, op[2], buf[cur], buf[cur], sv);
      }
      __syncthreads();
    }
    store_streams(p, buf[cur], out, n, tile, out_dim);
    __syncthreads();
  }
}

// ---- The tangent kernel ---------------------------------------------------
//
// The traversal and its tangent for a tangent `v_glob` of the packed weights
// (the same layout): the forward's recurrences on dual numbers.  A dense
// layer maps the pair (in, tin) to out = in.W (+ b on V) and tout = tin.W +
// in.Wv (+ bv on V), an activation as act_dual.
//
// What bounds it on an H100.  Three products a dense layer: at the 64-wide
// chain and 65,537 points, 8.24 G FMAs, 246 us at the card's 67 TFLOP/s of
// f32 FMA; a few MB cross device memory (1 us).  So the FMA pipes and what
// feeds them: shared-memory loads and the warps resident to hide their
// latency.  The first design (commit 6444749) kept W and Wv whole in shared
// memory beside four tile states (154,656 B at that chain: one 256-thread
// block an SM, 8 warps of 64), ran the three products as three passes over
// the state (15 shared loads per 48 FMAs, with 320 register tiles for 256
// threads and the 64 -> 1 layer on 20 threads walking K serially), and
// refused a chain whose block did not fit (128 wide): on an NVIDIA H100
// 80GB HBM3 at 700 W, 1.6004 ms at that shape, 15.4% of its bound, and
// 1.6317 ms (18.2%) with 6 streams.
//
// This design:
// * One fused dual product a layer.  A thread owns the same register tiles
//   (4 rows x 1 column, RB row groups) of out and tout for the whole layer
//   and, per K row, loads in and tin once per row group (one 16-byte load
//   each, the same address across the warp's 32 lanes) and W and Wv once
//   (32 lanes on 32 consecutive columns): at the 64-wide chain 12 loads for
//   60 FMAs, where the first design took 15 for 48.
// * A balanced map (dual_map): TC threads along the columns (N rounded up
//   to a power of two), TR along the row groups, so the tiles divide evenly
//   at the 64-wide chain (64 x 4 threads, 5 row groups each with 5 streams,
//   6 with 6).  Where the columns and row groups leave threads idle (the
//   64 -> 1 output layer) the remaining factor SK splits K; the partial sums
//   meet in shared memory and are added in ks order, so the tangent is
//   bitwise repeatable.  More than MAX_ROW_TILES row groups a thread (or
//   more columns than threads) take passes, the weights streamed again.
// * Weights streamed, not resident: each layer's rows arrive as K-slices of
//   RING_ROWS x wmax floats (W and Wv) through a ring of RING_SLOTS slots,
//   copied by cp.async (16-byte .cg copies, 4-byte ones at a slice's
//   unaligned ends); slice s + 2 lands while slice s is multiplied, one
//   barrier a slice.  A dense layer's first two slices start loading when
//   the previous dense layer ends, so they load under the activation.  Each
//   tile reads the weights again from L2 (about 68 KB a tile at the 64-wide
//   chain, 280 MB a launch at 65,537 points: some 50 us of L2 traffic,
//   under the products).
// * Shared memory is four tile states and the ring: 98,400 B at the 64-wide
//   chain (5 streams), 114,784 B with 6 streams, so two 256-thread blocks an
//   SM, 16 warps.  The plan (TaylorPlan in ops/fused_taylor.py) takes 16
//   points a tile, or 8 or 4 where the states at 16 do not fit: the kernel
//   takes every chain the forward and backward take (the 128-wide chain:
//   196,704 B, one block at 16 points).
// * Small chains keep the weights resident: where W and Wv together are at
//   most 32 KB (the plan's `jvp_resident`: the README and ODE chains, a
//   few KB), each block loads both whole once and a layer is one slice
//   with no waits and no per-slice barriers.  Streaming them cost those
//   launch-bound chains a slice wait and a barrier a layer (the times
//   below).
// * No tensor cores.  Plain TF32 keeps 10 mantissa bits and breaks the
//   values' 2e-5 tolerance; 3xTF32 triples the tensor work, and the gap to
//   the FMA bound is not the FMA rate (below).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --jvp-turns runs
// the first design and this one in turns): at the 64-wide chain and 65,537
// points 1.415 ms against 1.583 (17.4% of the bound), with 6 streams 1.564
// against 1.614; the occupancy calculator gives 2 blocks an SM at both.
// The gap is not the FMA rate.  In a variant (the map below, the stream
// across layers), the products without their FMAs and loads still took
// 0.58 ms of 1.59 (barriers, slice waits, epilogues) and the activations
// 0.18 ms.  Maps with fewer shared loads a FMA were slower: lanes along the
// row groups with a tile of 1 row group x 8 columns (18 loads per 96 FMAs,
// 160 busy threads: 1.47 ms), that map at 192 threads with the next K
// row's loads in registers (164 registers: 1.65 ms), and a weight stream
// running on across layers and tiles (1.59 ms).  Launch-bound shapes (a
// tile or two a block): streamed, 0.021 ms against 0.015 on the README
// chain at 1,024 points; with the weights resident 0.017 (0.89-0.92x), and
// the ODE chain at 512 points 0.011 against 0.011 (0.96-1.01x).

constexpr int RING_SLOTS = 3;
constexpr int RING_ROWS = 8;       // K rows of a slice at the widest layer
constexpr int MAX_ROW_TILES = 6;   // row groups a thread holds a pass
// The split-K partials (at most THREADS pairs of float4) alias the ring,
// or follow the weights where those are resident.
constexpr int SPLIT_FLOATS = 2 * 4 * THREADS;

__host__ __device__ int jvp_slot_floats(int wmax) {
  return ((RING_ROWS * wmax + 3) & ~3) + 4;  // + room for the alignment shift
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Floats from a 16-byte boundary to `src`: a slice lands that far into its
// slot, so that the slot and the source agree modulo 16 bytes.
__device__ __forceinline__ int align_shift(const float* src) {
  return static_cast<int>((reinterpret_cast<size_t>(src) >> 2) & 3);
}

// Starts the copy of `count` floats from `src` to `slot` + align_shift(src).
__device__ void copy_slice(float* slot, const float* src, int count) {
  const int shift = align_shift(src);
  float* dst = slot + shift;
  const int head = min(count, (4 - shift) & 3);
  const int chunks = (count - head) / 4;
  const int tail = head + 4 * chunks;
  const int items = head + chunks + (count - tail);
  for (int it = threadIdx.x; it < items; it += THREADS) {
    if (it < head) {
      cp_async4(dst + it, src + it);
    } else if (it < head + chunks) {
      const int i = head + 4 * (it - head);
      cp_async16(dst + i, src + i);
    } else {
      const int i = tail + (it - head - chunks);
      cp_async4(dst + i, src + i);
    }
  }
}

// How a block's threads share one dense layer (N columns, `groups` row
// groups of 4 rows): thread (tc, tr, ks) owns the columns tc + a * tcn
// (a < ca) and the row groups tr + b * trn (b < rb), over the K rows
// t = ks mod sk of each slice.  Threads with ks >= sk only copy and wait.
struct DualMap {
  int tcn, trn, sk, ca, rb;
  int tc, tr, ks;
  int chunks;  // passes over the row groups: ceil(rb / MAX_ROW_TILES)
  int passes;  // ca * chunks
};

__device__ DualMap dual_map(int N, int groups) {
  DualMap m;
  m.tcn = 1;
  while (m.tcn < N && m.tcn < THREADS) m.tcn <<= 1;
  m.ca = (N + m.tcn - 1) / m.tcn;
  const int rest = THREADS / m.tcn;
  m.trn = min(rest, groups);
  m.sk = rest / m.trn;
  m.rb = (groups + m.trn - 1) / m.trn;
  m.tc = threadIdx.x % m.tcn;
  const int r = threadIdx.x / m.tcn;
  m.tr = r % m.trn;
  m.ks = r / m.trn;
  m.chunks = (m.rb + MAX_ROW_TILES - 1) / MAX_ROW_TILES;
  m.passes = m.ca * m.chunks;
  return m;
}

// K rows of a layer's slice: RING_ROWS at the widest layer, more where N is
// narrower, at most K.
__device__ __forceinline__ int slice_rows(int K, int N, int wmax) {
  return min(K, RING_ROWS * wmax / N);
}

// Slice s of dense op `op` (the passes stream the same slices again) into
// its ring slot: W's rows and Wv's, one cp.async group.
__device__ void start_slice(const Plan& p, const int* op, int s,
                            const float* __restrict__ w_glob,
                            const float* __restrict__ v_glob, float* ring,
                            int slot_floats) {
  const int K = op[1], N = op[2];
  const int ksr = slice_rows(K, N, p.wmax);
  const int nsl = (K + ksr - 1) / ksr;
  const int k0 = (s % nsl) * ksr;
  const int off = op[3] + k0 * N, count = min(ksr, K - k0) * N;
  float* slot = ring + (s % RING_SLOTS) * 2 * slot_floats;
  copy_slice(slot, w_glob + off, count);
  copy_slice(slot + slot_floats, v_glob + off, count);
  cp_async_commit();
}

// Starts the first two slices of dense op `op`, ahead of its product.
__device__ void start_head(const Plan& p, const int* op,
                           const float* __restrict__ w_glob,
                           const float* __restrict__ v_glob, float* ring,
                           int slot_floats) {
  const int K = op[1], N = op[2];
  const int ksr = slice_rows(K, N, p.wmax);
  const int total = dual_map(N, p.rows / 4).passes * ((K + ksr - 1) / ksr);
  for (int s = 0; s < 2 && s < total; ++s)
    start_slice(p, op, s, w_glob, v_glob, ring, slot_floats);
}

// The dense layer on dual numbers, from (in, tin) into (out, tout).  With
// the weights resident (wres and vres, W and Wv whole in shared memory) a
// pass is one slice and waits for nothing; else its first two slices are
// already started (start_head) and `ring` is the ring.  `ring` holds the
// split-K partials in both.  Ends after a barrier.
template <int TP>
__device__ void dense_dual(const Plan& p, const int* op,
                           const float* __restrict__ w_glob,
                           const float* __restrict__ v_glob, const float* wres,
                           const float* vres, float* ring, int slot_floats,
                           const float* in, const float* tin, float* out,
                           float* tout) {
  const int K = op[1], N = op[2], w_off = op[3], b_off = op[4];
  const int groups = p.rows / 4;
  const DualMap m = dual_map(N, groups);
  const bool resident = wres != nullptr;
  const int ksr = resident ? K : slice_rows(K, N, p.wmax);
  const int nsl = (K + ksr - 1) / ksr;
  const int total = m.passes * nsl;
  const bool busy = m.ks < m.sk;
  float4 acc[MAX_ROW_TILES], tacc[MAX_ROW_TILES];
  int roff[MAX_ROW_TILES];
  int c = 0, nb = 0;
  float bias = 0.f, tbias = 0.f;
  for (int s = 0; s < total; ++s) {
    const int pass = s / nsl, j = s - pass * nsl;
    if (!resident) {
      if (s + 1 < total)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // slice s is in; every thread is past slice s - 1
      if (s + 2 < total)
        start_slice(p, op, s + 2, w_glob, v_glob, ring, slot_floats);
    }
    if (j == 0) {
      const int a = pass / m.chunks, bc = pass - a * m.chunks;
      c = m.tc + a * m.tcn;
      // The column's bias and its tangent, read now so that the read's
      // latency passes under the pass's products.
      const int bc_col = b_off + min(c, N - 1);
      bias = resident ? wres[bc_col] : w_glob[bc_col];
      tbias = resident ? vres[bc_col] : v_glob[bc_col];
      nb = min(MAX_ROW_TILES, m.rb - bc * MAX_ROW_TILES);
#pragma unroll
      for (int b = 0; b < MAX_ROW_TILES; ++b) {
        const int g = m.tr + (bc * MAX_ROW_TILES + b) * m.trn;
        roff[b] = 4 * min(g, groups - 1);
        acc[b] = make_float4(0.f, 0.f, 0.f, 0.f);
        tacc[b] = acc[b];
      }
    }
    const int k0 = j * ksr, rows = min(ksr, K - k0);
    const int cc = min(c, N - 1);
    const float* slot = ring + (s % RING_SLOTS) * 2 * slot_floats;
    const float* ws =
        resident ? wres + w_off + cc
                 : slot + align_shift(w_glob + w_off + k0 * N) + cc;
    const float* vs =
        resident ? vres + w_off + cc
                 : slot + slot_floats + align_shift(v_glob + w_off + k0 * N) + cc;
    if (busy) {
      for (int t = m.ks; t < rows; t += m.sk) {
        const float w = ws[t * N], wv = vs[t * N];
        const float* a = in + (k0 + t) * p.ld;
        const float* ta = tin + (k0 + t) * p.ld;
#pragma unroll
        for (int b = 0; b < MAX_ROW_TILES; ++b) {
          if (b < nb) {
            const float4 x = *reinterpret_cast<const float4*>(a + roff[b]);
            const float4 tx = *reinterpret_cast<const float4*>(ta + roff[b]);
            acc[b].x = fmaf(x.x, w, acc[b].x);
            acc[b].y = fmaf(x.y, w, acc[b].y);
            acc[b].z = fmaf(x.z, w, acc[b].z);
            acc[b].w = fmaf(x.w, w, acc[b].w);
            tacc[b].x = fmaf(x.x, wv, fmaf(tx.x, w, tacc[b].x));
            tacc[b].y = fmaf(x.y, wv, fmaf(tx.y, w, tacc[b].y));
            tacc[b].z = fmaf(x.z, wv, fmaf(tx.z, w, tacc[b].z));
            tacc[b].w = fmaf(x.w, wv, fmaf(tx.w, w, tacc[b].w));
          }
        }
      }
    }
    if (j + 1 < nsl) continue;
    // The pass's epilogue.  Split K: the partials of ks > 0 go to shared
    // memory (aliasing the ring, which every thread is done reading; the
    // first barrier also keeps the previous pass's partials until read),
    // and ks == 0 adds them in ks order.
    if (m.sk > 1) {
      float4* part = reinterpret_cast<float4*>(ring);
      const int plane = m.trn * m.tcn, own = m.tr * m.tcn + m.tc;
      __syncthreads();
      if (m.ks > 0 && busy) {
        part[2 * ((m.ks - 1) * plane + own)] = acc[0];
        part[2 * ((m.ks - 1) * plane + own) + 1] = tacc[0];
      }
      __syncthreads();
      if (m.ks == 0) {
        for (int q = 1; q < m.sk; ++q) {
          const float4 u = part[2 * ((q - 1) * plane + own)];
          const float4 tu = part[2 * ((q - 1) * plane + own) + 1];
          acc[0].x += u.x;
          acc[0].y += u.y;
          acc[0].z += u.z;
          acc[0].w += u.w;
          tacc[0].x += tu.x;
          tacc[0].y += tu.y;
          tacc[0].z += tu.z;
          tacc[0].w += tu.w;
        }
      }
    }
    if (m.ks == 0 && c < N) {
      const int bc = pass % m.chunks;
#pragma unroll
      for (int b = 0; b < MAX_ROW_TILES; ++b) {
        const int g = m.tr + (bc * MAX_ROW_TILES + b) * m.trn;
        if (b < nb && g < groups) {
          float4 o = acc[b], to = tacc[b];
          if (4 * g < TP) {  // the V rows
            o.x += bias;
            o.y += bias;
            o.z += bias;
            o.w += bias;
            to.x += tbias;
            to.y += tbias;
            to.z += tbias;
            to.w += tbias;
          }
          *reinterpret_cast<float4*>(out + c * p.ld + 4 * g) = o;
          *reinterpret_cast<float4*>(tout + c * p.ld + 4 * g) = to;
        }
      }
    }
  }
  __syncthreads();
}

// The index of the first dense op after op `o`, or -1.
__device__ int next_dense(const Plan& p, int o) {
  for (int i = o + 1; i < p.n_ops; ++i)
    if (p.ops[i * OP_INTS] == 0) return i;
  return -1;
}

// TP points a tile (16, or 8 or 4 where the states at 16 do not fit: the
// plan's choice); the block holds four tile states (primal and tangent, in
// and out) and the ring, or, with `resident` (the plan's choice for small
// chains), W and Wv whole (P floats each) and the split-K partials.  The
// input is x or, with INPUT_STATE, xs, as the forward's.
template <int TP, bool INPUT_STATE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
taylor_jvp_kernel(const float* __restrict__ x, const float* __restrict__ xs,
                  const float* __restrict__ w_glob,
                  const float* __restrict__ v_glob, const int* __restrict__ tab,
                  float* __restrict__ out, float* __restrict__ tout, int n,
                  int out_dim, int P, int resident) {
  extern __shared__ float4 smem4[];
  const Plan p = read_plan(tab, TP);
  const size_t member = blockIdx.y;
  w_glob += member * P;
  v_glob += member * P;
  out += member * n * p.n_streams * out_dim;
  tout += member * n * p.n_streams * out_dim;
  float* buf[2];
  float* tbuf[2];
  buf[0] = reinterpret_cast<float*>(smem4);
  buf[1] = buf[0] + p.wmax * p.ld;
  tbuf[0] = buf[1] + p.wmax * p.ld;
  tbuf[1] = tbuf[0] + p.wmax * p.ld;
  float* ring = tbuf[1] + p.wmax * p.ld;
  float* wres = nullptr;
  float* vres = nullptr;
  if (resident) {
    wres = ring;
    vres = wres + weights_floats(P);
    ring = vres + weights_floats(P);
    load_weights_async(wres, w_glob, P);
    load_weights_async(vres, v_glob, P);
  }
  const int slot_floats = jvp_slot_floats(p.wmax);
  const int tiles = (n + TP - 1) / TP;
  const int first = next_dense(p, -1);
  if (!resident && first >= 0 && (int)blockIdx.x < tiles)
    start_head(p, p.ops + first * OP_INTS, w_glob, v_glob, ring, slot_floats);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    start_state<INPUT_STATE, TP>(p, buf[0], x, xs, n, tile);
    // The input state does not depend on the weights: its tangent is 0.
    for (int idx = threadIdx.x; idx < p.in_dim * p.rows; idx += THREADS) {
      const int k = idx / p.rows;
      tbuf[0][k * p.ld + idx - k * p.rows] = 0.f;
    }
    if (resident) wait_weights();
    __syncthreads();
    int cur = 0, width = p.in_dim;
    for (int o = 0; o < p.n_ops; ++o) {
      const int* op = p.ops + o * OP_INTS;
      if (op[0] == 0) {
        dense_dual<TP>(p, op, w_glob, v_glob, wres, vres, ring, slot_floats,
                       buf[cur], tbuf[cur], buf[1 - cur], tbuf[1 - cur]);
        cur = 1 - cur;
        width = op[2];
        // The next dense layer's head, this tile's or the next tile's.
        const int nd = next_dense(p, o);
        if (!resident && nd >= 0)
          start_head(p, p.ops + nd * OP_INTS, w_glob, v_glob, ring,
                     slot_floats);
        else if (!resident && tile + (int)gridDim.x < tiles)
          start_head(p, p.ops + first * OP_INTS, w_glob, v_glob, ring,
                     slot_floats);
      } else {
        act_dual<TP>(p, width, op[2], buf[cur], tbuf[cur]);
        __syncthreads();
      }
    }
    store_streams<TP>(p, buf[cur], out, n, tile, out_dim);
    store_streams<TP>(p, tbuf[cur], tout, n, tile, out_dim);
    __syncthreads();
  }
}

// Starts the copy of features [0, width) of saved rows (stride p.rows, 16-byte
// aligned) into `buf` (stride p.ld), one cp.async group.
__device__ void stage_state(const Plan& p, const float* src, int width,
                            float* buf) {
  constexpr int CHUNKS = TILE_POINTS / 4;  // 16-byte copies a row
  const int rows = width * p.n_streams;
  for (int c = threadIdx.x; c < rows * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, q = c - r * CHUNKS;
    const int j = r / p.n_streams, s = r - j * p.n_streams;
    cp_async16(buf + j * p.ld + s * TILE_POINTS + 4 * q,
               src + r * TILE_POINTS + 4 * q);
  }
  cp_async_commit();
}

// The saved rows a dense op's input comes from (its index > 0): the
// previous activation's input, or its own where the previous op is dense.
__device__ const float* dense_source(const int* op, const float* slab) {
  const int* prev = op - OP_INTS;
  return slab + (prev[0] == 1 ? prev[5] : op[5]) * TILE_POINTS;
}

// FROM_STATES: `saves` holds a forward's states (members, tiles, save_rows,
// TILE_POINTS) and no forward is run; else `saves` holds the per-block
// slabs (members * gridDim.x, save_rows, TILE_POINTS) that each tile's
// replay of the forward fills.  The adjoint is the same: it stages each
// saved state into shared memory (stage_state, cp.async) and reads it
// there.  The input is x or, with INPUT_STATE, xs, as the forward's.  dx
// gets the input's cotangent: x's (members, n, in_dim), the V rows only; or
// with INPUT_STATE the whole state's (members, n, n_streams, in_dim), and
// none where dx is null.
template <bool FROM_STATES, bool INPUT_STATE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
taylor_bwd_kernel(const float* __restrict__ x, const float* __restrict__ xs,
                  const float* __restrict__ w_glob, const int* __restrict__ tab,
                  const float* __restrict__ g, float* __restrict__ saves,
                  float* __restrict__ partials, float* __restrict__ dx, int n,
                  int P, int out_dim) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  const Plan p = read_plan(tab);
  float* buf[3];
  buf[0] = w + weights_floats(P);
  buf[1] = buf[0] + p.wmax * p.ld;
  buf[2] = buf[1] + p.wmax * p.ld;
  // Member k's weights, cotangent, d x and states; block (b, k)'s slab and
  // partial are slot k * gridDim.x + b.
  const size_t member = blockIdx.y;
  const size_t slot = member * gridDim.x + blockIdx.x;
  w_glob += member * P;
  g += member * n * p.n_streams * out_dim;
  if constexpr (INPUT_STATE) {
    if (dx != nullptr) dx += member * n * p.n_streams * p.in_dim;
  } else {
    dx += member * n * p.in_dim;
  }
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  const size_t tile_floats = (size_t)p.save_rows * TILE_POINTS;
  float* slab = saves + slot * tile_floats;
  float* part = partials + slot * P;
  load_weights_async(w, w_glob, P);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    if constexpr (FROM_STATES) {
      slab = saves + (member * tiles + tile) * tile_floats;
      wait_weights();
    } else {
      // Recompute the forward, keeping what the adjoint reads.  The last
      // op's output is not needed.
      start_state<INPUT_STATE>(p, buf[0], x, xs, n, tile);
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
          act_columns(p, width, op[2], buf[cur], buf[cur], sv);
        }
        __syncthreads();
      }
    }

    // The adjoint, last op first.  buf[gi] holds the cotangent; buf[ri] a
    // staged saved state (-1: none): the next dense layer's source, staged
    // while the activation above it runs its adjoint, and kept after the
    // layer for the adjoint of the activation below it.
    int gi = 0, ri = -1;
    load_cotangent(p, g, buf[gi], n, tile, out_dim);
    const int last = p.n_ops - 1;
    if (last > 0 && p.ops[last * OP_INTS] == 0) {
      ri = 2;
      stage_state(p, dense_source(p.ops + last * OP_INTS, slab),
                  p.ops[last * OP_INTS + 1], buf[ri]);
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int o = last; o >= 0; --o) {
      const int* op = p.ops + o * OP_INTS;
      if (op[0] == 0) {
        const int K = op[1], N = op[2];
        // The layer's input buf[xi]: x; the previous activation applied,
        // out of place, to its staged input; or the staged output of the
        // previous dense layer.  The cotangent below goes to buf[oi].
        int xi, oi;
        if (o == 0) {
          xi = (gi + 1) % 3;
          oi = 3 - gi - xi;
          start_state<INPUT_STATE>(p, buf[xi], x, xs, n, tile);
        } else {
          if (ri < 0) {
            ri = (gi + 1) % 3;
            stage_state(p, dense_source(op, slab), K, buf[ri]);
          }
          cp_async_wait<0>();
          __syncthreads();
          const int* prev = op - OP_INTS;
          if (prev[0] == 1) {
            xi = oi = 3 - gi - ri;
            act_columns(p, K, prev[2], buf[ri], buf[xi], nullptr);
          } else {
            xi = ri;
            oi = 3 - gi - xi;
            ri = -1;
          }
        }
        __syncthreads();
        param_grad(buf[xi], buf[gi], p.ld, p.rows, K, N, part + op[3],
                   part + op[4], first);
        // G_in[k][r] = sum_j G[j][r] * W[k][j]; below the first layer only
        // the input's rows are needed (x's V rows, or the whole state), and
        // none without dx.  Into the input's buffer once param_grad is done
        // with it, where the staged state is kept.
        if (!INPUT_STATE || o > 0 || dx != nullptr) {
          if (oi == xi) __syncthreads();
          product(buf[gi], buf[oi], p.ld,
                  INPUT_STATE || o > 0 ? p.rows : TILE_POINTS, N, K,
                  w + op[3], N, 1, nullptr);
        }
        __syncthreads();
        gi = oi;
      } else {
        // The activation's input: kept from the dense layer above, or
        // staged now.  The dense layer below stages its source meanwhile.
        int si = ri;
        if (si < 0) {
          si = (gi + 1) % 3;
          stage_state(p, slab + op[5] * TILE_POINTS, op[1], buf[si]);
        }
        ri = -1;
        if (o > 1 && op[-OP_INTS] == 0) {
          ri = 3 - gi - si;
          stage_state(p, dense_source(op - OP_INTS, slab), op[-OP_INTS + 1],
                      buf[ri]);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        act_adjoint(p, op[1], op[2], buf[si], buf[gi]);
        __syncthreads();
      }
    }
    if constexpr (INPUT_STATE) {
      // Element (point m, column c) of the state's cotangent, c = s * in_dim
      // + k, lies at feature k, row s * TILE_POINTS + m.
      const int cols = p.n_streams * p.in_dim;
      for (int idx = threadIdx.x; dx != nullptr && idx < TILE_POINTS * cols;
           idx += THREADS) {
        const int m = idx / cols, c = idx - m * cols;
        const int s = c / p.in_dim, k = c - s * p.in_dim;
        const int row = tile * TILE_POINTS + m;
        if (row < n)
          dx[(size_t)row * cols + c] = buf[gi][k * p.ld + s * TILE_POINTS + m];
      }
    } else {
      for (int idx = threadIdx.x; idx < TILE_POINTS * p.in_dim;
           idx += THREADS) {
        const int m = idx / p.in_dim, k = idx - m * p.in_dim;
        const int row = tile * TILE_POINTS + m;
        if (row < n) dx[(size_t)row * p.in_dim + k] = buf[gi][k * p.ld + m];
      }
    }
    __syncthreads();
  }
}

// Sums the per-block partial gradients over blocks, in block order; member
// blockIdx.y's `n_blocks` partials into its row of `out` (K, P).
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int n_blocks,
                                       int P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  partials += (size_t)blockIdx.y * n_blocks * P;
  out += (size_t)blockIdx.y * P;
  float acc = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) acc += partials[(size_t)blk * P + i];
  out[i] = acc;
}

size_t taylor_smem_bytes(int P, int n_streams, int wmax, int n_bufs) {
  const size_t ld = (size_t)n_streams * TILE_POINTS + ROW_PAD;
  return sizeof(float) * ((size_t)weights_floats(P) + (size_t)n_bufs * wmax * ld);
}

// The tangent kernel's block: four tile states of `tile` points and the
// ring (or the split-K partials it holds, where they are larger); with
// `resident`, W and Wv whole and the split-K partials.
size_t taylor_jvp_smem_bytes(int n_streams, int wmax, int tile, int P,
                             int resident) {
  const size_t ld = (size_t)n_streams * tile + ROW_PAD;
  const size_t ring = (size_t)RING_SLOTS * 2 * jvp_slot_floats(wmax);
  const size_t region =
      resident ? 2 * (size_t)weights_floats(P) + SPLIT_FLOATS
               : (ring > SPLIT_FLOATS ? ring : (size_t)SPLIT_FLOATS);
  return sizeof(float) * (4 * (size_t)wmax * ld + region);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Blocks of `kernel` at `smem` bytes that one SM holds at once, from the
// occupancy calculator (registers and shared memory), or a negative CUDA
// error code.
int blocks_per_sm(const void* kernel, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                      smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <int TP, bool INPUT_STATE>
int launch_jvp_as(const float* x, const float* xs, const float* w,
                  const float* v, const int* tab, float* out, float* tout,
                  int n, size_t smem, int out_dim, int P, int resident,
                  int grid, int members, cudaStream_t stream) {
  cudaError_t err =
      allow_smem((const void*)taylor_jvp_kernel<TP, INPUT_STATE>, smem);
  if (err != cudaSuccess) return (int)err;
  taylor_jvp_kernel<TP, INPUT_STATE>
      <<<dim3(grid, members), THREADS, smem, stream>>>(
          x, xs, w, v, tab, out, tout, n, out_dim, P, resident);
  return (int)cudaGetLastError();
}

// The tangent kernel's instance for the input: x, or the input state xs.
template <int TP>
int launch_jvp(const float* x, const float* xs, const float* w, const float* v,
               const int* tab, float* out, float* tout, int n, size_t smem,
               int out_dim, int P, int resident, int grid, int members,
               cudaStream_t stream) {
  return xs != nullptr
             ? launch_jvp_as<TP, true>(x, xs, w, v, tab, out, tout, n, smem,
                                       out_dim, P, resident, grid, members,
                                       stream)
             : launch_jvp_as<TP, false>(x, xs, w, v, tab, out, tout, n, smem,
                                        out_dim, P, resident, grid, members,
                                        stream);
}

template <bool FROM_STATES, bool INPUT_STATE>
cudaError_t launch_bwd_as(const float* x, const float* xs, const float* w,
                          const int* tab, const float* g, float* saves,
                          float* partials, float* dx, int n, int P,
                          int out_dim, size_t smem, int grid, int members,
                          cudaStream_t stream) {
  cudaError_t err = allow_smem(
      (const void*)taylor_bwd_kernel<FROM_STATES, INPUT_STATE>, smem);
  if (err != cudaSuccess) return err;
  taylor_bwd_kernel<FROM_STATES, INPUT_STATE>
      <<<dim3(grid, members), THREADS, smem, stream>>>(
          x, xs, w, tab, g, saves, partials, dx, n, P, out_dim);
  return cudaGetLastError();
}

// The backward's instance for the input: x, or the input state xs.
template <bool FROM_STATES>
cudaError_t launch_bwd(const float* x, const float* xs, const float* w,
                       const int* tab, const float* g, float* saves,
                       float* partials, float* dx, int n, int P, int out_dim,
                       size_t smem, int grid, int members,
                       cudaStream_t stream) {
  return xs != nullptr
             ? launch_bwd_as<FROM_STATES, true>(x, xs, w, tab, g, saves,
                                                partials, dx, n, P, out_dim,
                                                smem, grid, members, stream)
             : launch_bwd_as<FROM_STATES, false>(x, xs, w, tab, g, saves,
                                                 partials, dx, n, P, out_dim,
                                                 smem, grid, members, stream);
}

}  // namespace

extern "C" {

int pdt_taylor_tile_points() { return TILE_POINTS; }

// Blocks of the tangent kernel one SM holds at once at this plan's sizes
// (`tile` points a tile, weights `resident` or streamed), or a negative
// CUDA error code.
int pdt_taylor_jvp_blocks_per_sm(int n_streams, int wmax, int tile, int P,
                                 int resident) {
  const size_t smem = taylor_jvp_smem_bytes(n_streams, wmax, tile, P, resident);
  if (tile == 16)
    return blocks_per_sm((const void*)taylor_jvp_kernel<16, false>, smem);
  if (tile == 8)
    return blocks_per_sm((const void*)taylor_jvp_kernel<8, false>, smem);
  if (tile == 4)
    return blocks_per_sm((const void*)taylor_jvp_kernel<4, false>, smem);
  return -(int)cudaErrorInvalidValue;
}

// Blocks one SM holds at once of the forward (kernel 0), the backward that
// recomputes (1) or the backward from a forward's states (2) at these
// sizes, or a negative CUDA error code.
int pdt_taylor_blocks_per_sm(int kernel, int P, int n_streams, int wmax) {
  if (kernel == 0)
    return blocks_per_sm((const void*)taylor_fwd_kernel<false>,
                         taylor_smem_bytes(P, n_streams, wmax, 2));
  const size_t smem = taylor_smem_bytes(P, n_streams, wmax, 3);
  if (kernel == 1)
    return blocks_per_sm((const void*)taylor_bwd_kernel<false, false>, smem);
  if (kernel == 2)
    return blocks_per_sm((const void*)taylor_bwd_kernel<true, false>, smem);
  return -(int)cudaErrorInvalidValue;
}

// x (n, in_dim), or null and xs (n, n_streams, in_dim) an embedding's
// Taylor state; w (members, P), tab (device op table), out (members, n,
// n_streams*out_dim), states (members, tiles, save_rows, TILE_POINTS) or
// null; `grid` persistent blocks a member.
int pdt_taylor_forward(const float* x, const float* xs, const float* w,
                       const int* tab, float* out, float* states, int n,
                       int P, int n_streams, int wmax, int out_dim, int grid,
                       int members, void* stream) {
  const size_t smem = taylor_smem_bytes(P, n_streams, wmax, 2);
  cudaError_t err = allow_smem(xs != nullptr
                                   ? (const void*)taylor_fwd_kernel<true>
                                   : (const void*)taylor_fwd_kernel<false>,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks(grid, members);
  const cudaStream_t st = (cudaStream_t)stream;
  if (xs != nullptr)
    taylor_fwd_kernel<true><<<blocks, THREADS, smem, st>>>(
        x, xs, w, tab, out, states, n, P, out_dim);
  else
    taylor_fwd_kernel<false><<<blocks, THREADS, smem, st>>>(
        x, xs, w, tab, out, states, n, P, out_dim);
  return (int)cudaGetLastError();
}

// x or xs as the forward's; w and v (members, P), tab, out and tout
// (members, n, n_streams*out_dim); `tile` points a tile (16, 8 or 4), the
// weights `resident` (1) or streamed (0), `grid` persistent blocks a member.
int pdt_taylor_jvp(const float* x, const float* xs, const float* w,
                   const float* v, const int* tab, float* out, float* tout,
                   int n, int P, int n_streams, int wmax, int out_dim,
                   int tile, int resident, int grid, int members,
                   void* stream) {
  const size_t smem = taylor_jvp_smem_bytes(n_streams, wmax, tile, P, resident);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile == 16)
    return launch_jvp<16>(x, xs, w, v, tab, out, tout, n, smem, out_dim, P,
                          resident, grid, members, st);
  if (tile == 8)
    return launch_jvp<8>(x, xs, w, v, tab, out, tout, n, smem, out_dim, P,
                         resident, grid, members, st);
  if (tile == 4)
    return launch_jvp<4>(x, xs, w, v, tab, out, tout, n, smem, out_dim, P,
                         resident, grid, members, st);
  return (int)cudaErrorInvalidValue;
}

// x or xs as the forward's; g (members, n, n_streams*out_dim); saves, with
// from_states, a forward's states (members, tiles, save_rows, TILE_POINTS),
// else the slabs (members * grid * save_rows * TILE_POINTS); partials
// (members * grid * P); dw (members, P); dx (members, n, in_dim), with xs
// (members, n, n_streams, in_dim) or null.  grid (blocks a member) <= number
// of tiles.
int pdt_taylor_backward(const float* x, const float* xs, const float* w,
                        const int* tab, const float* g, float* saves,
                        float* partials, float* dw, float* dx, int n, int P,
                        int n_streams, int wmax, int out_dim, int grid,
                        int members, int from_states, void* stream) {
  const size_t smem = taylor_smem_bytes(P, n_streams, wmax, 3);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = from_states
      ? launch_bwd<true>(x, xs, w, tab, g, saves, partials, dx, n, P, out_dim,
                         smem, grid, members, st)
      : launch_bwd<false>(x, xs, w, tab, g, saves, partials, dx, n, P,
                          out_dim, smem, grid, members, st);
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<dim3((P + 255) / 256, members), 256, 0, st>>>(
      partials, dw, grid, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
