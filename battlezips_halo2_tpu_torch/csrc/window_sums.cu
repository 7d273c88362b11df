// K3: the window aggregation of Pippenger's MSM in one launch, over
// interleaved points: buckets (rows, nbuck, 3, 8) -> (rows, 3, 8),
// T = sum_{b=1..m} b S_b for every row. The body, its design and its bound
// are in csrc/window_body.cuh, shared with K6's planar kernel.
//
// Replaces battlezips_halo2_tpu/ops/pallas_kernels.py:414 point_add_T
// (_point_add_T_call), which the reference launched once per addition of
// its two-level running sums. The Montgomery product is inlined here.
#include "window_body.cuh"

__global__ void __launch_bounds__(BZ_WS_BLOCK)
    window_sums_kernel(FieldConsts F, const uint32_t* __restrict__ buckets, uint32_t* __restrict__ out,
                       long long rows, int nbuck, int log_threads, int seg) {
  __shared__ uint32_t buf[3 * BZ_NL * BZ_WS_BLOCK];
  window_sums_body<false>(F, buckets, out, rows, nbuck, log_threads, seg, buf);
}

extern "C" int bz_window_sums(const uint32_t* consts, const void* buckets, void* out, long long rows, int nbuck,
                              int log_threads, int seg, void* stream) {
  if (!window_args_ok(nbuck, log_threads, seg)) return (int)cudaErrorInvalidValue;
  const FieldConsts F = field_consts(consts);
  window_sums_kernel<<<window_grid(rows, log_threads), BZ_WS_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const uint32_t*>(buckets), static_cast<uint32_t*>(out), rows, nbuck, log_threads, seg);
  return (int)cudaGetLastError();
}

// Threads of window_sums_kernel the current card holds at once.
extern "C" int bz_window_resident(long long* threads) {
  return window_resident_threads(window_sums_kernel, threads);
}
