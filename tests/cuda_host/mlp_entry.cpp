// C entries of the host-emulated MLP kernel, appended to the kernel source
// by tests/test_torch_mlp_kernel_host.py.
extern "C" {

int host_mlp_threads() { return THREADS; }

int host_mlp_smem_bytes(int staged, int in_dim, int wmax, int max_stack,
                        int tile) {
  return (int)(sizeof(float) *
               mlp_smem_floats(staged, in_dim, wmax, max_stack, tile));
}

void host_mlp_forward(const float* x, const float* w, const int* tab,
                      float* out, int n, int staged, int in_dim, int wmax,
                      int max_stack, int tile, int out_dim, int P, int grid,
                      int members) {
  const size_t smem =
      sizeof(float) * mlp_smem_floats(staged, in_dim, wmax, max_stack, tile);
  auto run = [&](auto kernel) {
    host_launch(grid, THREADS, smem,
                [&] { kernel(x, w, tab, out, n, out_dim, P); }, members);
  };
  if (tile == 128) run(mlp_fwd_kernel<128>);
  if (tile == 64) run(mlp_fwd_kernel<64>);
  if (tile == 32) run(mlp_fwd_kernel<32>);
}

}  // extern "C"
