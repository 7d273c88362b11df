// K6: the window aggregation of Pippenger's MSM with the points held as
// coordinate planes: a batch of n points is (3, n, 8), the X, Y and Z
// planes each contiguous (n rows of 8 x 32-bit limbs).
//
// Replaces battlezips_halo2_tpu/ops/pallas_kernels.py:167 point_add_rows
// (_point_add_call), which took X, Y, Z as six separate (rows, 16) inputs
// and gave three outputs, and which the reference's MSM under BZ_ROW_MSM
// launched once per addition of its window aggregation. This file holds
// bz_window_sums_planes, what the MSM runs: the aggregation of a whole
// bucket pass in one launch, buckets (3, rows, nbuck, 8) -> (3, rows, 8),
// T = sum_{b=1..m} b S_b for every row. Its body is K3's
// (csrc/window_body.cuh), addressing a point's coordinates in their
// planes; its design and bound are described there. K6's lane-wise
// addition over planes, bz_point_add_planes, lives in csrc/point_add.cu
// beside K3's, on the carry-chain field ops.
//
// The kernel calls one out-of-line Montgomery product (BZ_FE_MUL_CALL,
// csrc/field.cuh): it holds 121 registers instead of 188, and took 6.4 ms
// of a row-configuration board proof's device time instead of 14.7 with
// the product inlined (PERF.md §6).
#define BZ_FE_MUL_CALL
#include "window_body.cuh"

__global__ void __launch_bounds__(BZ_WS_BLOCK)
    window_sums_planes_kernel(FieldConsts F, const uint32_t* __restrict__ buckets, uint32_t* __restrict__ out,
                              long long rows, int nbuck, int log_threads, int seg) {
  __shared__ uint32_t buf[3 * BZ_NL * BZ_WS_BLOCK];
  window_sums_body<true>(F, buckets, out, rows, nbuck, log_threads, seg, buf);
}

extern "C" int bz_window_sums_planes(const uint32_t* consts, const void* buckets, void* out, long long rows,
                                     int nbuck, int log_threads, int seg, void* stream) {
  if (!window_args_ok(nbuck, log_threads, seg)) return (int)cudaErrorInvalidValue;
  const FieldConsts F = field_consts(consts);
  window_sums_planes_kernel<<<window_grid(rows, log_threads), BZ_WS_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const uint32_t*>(buckets), static_cast<uint32_t*>(out), rows, nbuck, log_threads, seg);
  return (int)cudaGetLastError();
}

// Threads of window_sums_planes_kernel the current card holds at once.
extern "C" int bz_window_planes_resident(long long* threads) {
  return window_resident_threads(window_sums_planes_kernel, threads);
}
