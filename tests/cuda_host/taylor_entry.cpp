// C entries of the host-emulated Taylor kernels, appended to the kernel
// source by tests/test_torch_taylor_kernel_host.py.
extern "C" {

int host_taylor_tile_points() { return TILE_POINTS; }

int host_taylor_smem_bytes(int P, int S, int W, int n_bufs) {
  return (int)taylor_smem_bytes(P, S, W, n_bufs);
}

void host_taylor_forward(const float* x, const float* w, const int* tab,
                         float* out, int n, int P, int S, int W, int out_dim,
                         int grid) {
  host_launch(grid, THREADS, taylor_smem_bytes(P, S, W, 2),
              [&] { taylor_fwd_kernel(x, w, tab, out, n, P, out_dim); });
}

void host_taylor_backward(const float* x, const float* w, const int* tab,
                          const float* g, float* saves, float* partials,
                          float* dw, float* dx, int n, int P, int S, int W,
                          int out_dim, int grid) {
  host_launch(grid, THREADS, taylor_smem_bytes(P, S, W, 3), [&] {
    taylor_bwd_kernel(x, w, tab, g, saves, partials, dx, n, P, out_dim);
  });
  host_launch((P + 255) / 256, 256, 0,
              [&] { reduce_partials_kernel(partials, dw, grid, P); });
}

}  // extern "C"
