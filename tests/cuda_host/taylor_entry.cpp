// C entries of the host-emulated Taylor kernels, appended to the kernel
// source by tests/test_torch_taylor_kernel_host.py.  `members` is the
// grid's second axis (an ensemble's members; their weights (members, P)).
// The input is x, or with `xs` an embedding's Taylor state (n, n_streams,
// in_dim) and x null.

// The tangent kernel's instance for the input: x, or the input state xs.
template <int TP>
void host_jvp(const float* x, const float* xs, const float* w, const float* v,
              const int* tab, float* out, float* tout, int n, int out_dim,
              int P, int resident) {
  if (xs != nullptr)
    taylor_jvp_kernel<TP, true>(x, xs, w, v, tab, out, tout, n, out_dim, P,
                                resident);
  else
    taylor_jvp_kernel<TP, false>(x, xs, w, v, tab, out, tout, n, out_dim, P,
                                 resident);
}

extern "C" {

int host_taylor_tile_points() { return TILE_POINTS; }

int host_taylor_smem_bytes(int P, int S, int W, int n_bufs) {
  return (int)taylor_smem_bytes(P, S, W, n_bufs);
}

void host_taylor_forward(const float* x, const float* xs, const float* w,
                         const int* tab, float* out, float* states, int n,
                         int P, int S, int W, int out_dim, int grid,
                         int members) {
  host_launch(grid, THREADS, taylor_smem_bytes(P, S, W, 2), [&] {
    if (xs != nullptr)
      taylor_fwd_kernel<true>(x, xs, w, tab, out, states, n, P, out_dim);
    else
      taylor_fwd_kernel<false>(x, xs, w, tab, out, states, n, P, out_dim);
  }, members);
}

int host_taylor_jvp_smem_bytes(int S, int W, int tile, int P, int resident) {
  return (int)taylor_jvp_smem_bytes(S, W, tile, P, resident);
}

void host_taylor_jvp(const float* x, const float* xs, const float* w,
                     const float* v, const int* tab, float* out, float* tout,
                     int n, int P, int S, int W, int out_dim, int tile,
                     int resident, int grid, int members) {
  const size_t smem = taylor_jvp_smem_bytes(S, W, tile, P, resident);
  host_launch(grid, THREADS, smem, [&] {
    if (tile == 16)
      host_jvp<16>(x, xs, w, v, tab, out, tout, n, out_dim, P, resident);
    else if (tile == 8)
      host_jvp<8>(x, xs, w, v, tab, out, tout, n, out_dim, P, resident);
    else
      host_jvp<4>(x, xs, w, v, tab, out, tout, n, out_dim, P, resident);
  }, members);
}

// `saves`: with from_states a forward's states, else the per-block slabs.
void host_taylor_backward(const float* x, const float* xs, const float* w,
                          const int* tab, const float* g, float* saves,
                          float* partials, float* dw, float* dx, int n, int P,
                          int S, int W, int out_dim, int grid, int members,
                          int from_states) {
  host_launch(grid, THREADS, taylor_smem_bytes(P, S, W, 3), [&] {
    if (from_states && xs != nullptr)
      taylor_bwd_kernel<true, true>(x, xs, w, tab, g, saves, partials, dx, n,
                                    P, out_dim);
    else if (from_states)
      taylor_bwd_kernel<true, false>(x, xs, w, tab, g, saves, partials, dx, n,
                                     P, out_dim);
    else if (xs != nullptr)
      taylor_bwd_kernel<false, true>(x, xs, w, tab, g, saves, partials, dx, n,
                                     P, out_dim);
    else
      taylor_bwd_kernel<false, false>(x, xs, w, tab, g, saves, partials, dx,
                                      n, P, out_dim);
  }, members);
  host_launch((P + 255) / 256, 256, 0,
              [&] { reduce_partials_kernel(partials, dw, grid, P); }, members);
}

}  // extern "C"
