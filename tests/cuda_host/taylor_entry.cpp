// C entries of the host-emulated Taylor kernels, appended to the kernel
// source by tests/test_torch_taylor_kernel_host.py.  `members` is the
// grid's second axis (an ensemble's members; their weights (members, P)).
extern "C" {

int host_taylor_tile_points() { return TILE_POINTS; }

int host_taylor_smem_bytes(int P, int S, int W, int n_bufs) {
  return (int)taylor_smem_bytes(P, S, W, n_bufs);
}

void host_taylor_forward(const float* x, const float* w, const int* tab,
                         float* out, float* states, int n, int P, int S, int W,
                         int out_dim, int grid, int members) {
  host_launch(
      grid, THREADS, taylor_smem_bytes(P, S, W, 2),
      [&] { taylor_fwd_kernel(x, w, tab, out, states, n, P, out_dim); },
      members);
}

int host_taylor_jvp_smem_bytes(int S, int W, int tile, int P, int resident) {
  return (int)taylor_jvp_smem_bytes(S, W, tile, P, resident);
}

void host_taylor_jvp(const float* x, const float* w, const float* v,
                     const int* tab, float* out, float* tout, int n, int P,
                     int S, int W, int out_dim, int tile, int resident,
                     int grid, int members) {
  const size_t smem = taylor_jvp_smem_bytes(S, W, tile, P, resident);
  if (tile == 16)
    host_launch(grid, THREADS, smem, [&] {
      taylor_jvp_kernel<16>(x, w, v, tab, out, tout, n, out_dim, P, resident);
    }, members);
  else if (tile == 8)
    host_launch(grid, THREADS, smem, [&] {
      taylor_jvp_kernel<8>(x, w, v, tab, out, tout, n, out_dim, P, resident);
    }, members);
  else
    host_launch(grid, THREADS, smem, [&] {
      taylor_jvp_kernel<4>(x, w, v, tab, out, tout, n, out_dim, P, resident);
    }, members);
}

// `saves`: with from_states a forward's states, else the per-block slabs.
void host_taylor_backward(const float* x, const float* w, const int* tab,
                          const float* g, float* saves, float* partials,
                          float* dw, float* dx, int n, int P, int S, int W,
                          int out_dim, int grid, int members,
                          int from_states) {
  host_launch(grid, THREADS, taylor_smem_bytes(P, S, W, 3), [&] {
    if (from_states)
      taylor_bwd_kernel<true>(x, w, tab, g, saves, partials, dx, n, P,
                              out_dim);
    else
      taylor_bwd_kernel<false>(x, w, tab, g, saves, partials, dx, n, P,
                               out_dim);
  }, members);
  host_launch((P + 255) / 256, 256, 0,
              [&] { reduce_partials_kernel(partials, dw, grid, P); }, members);
}

}  // extern "C"
