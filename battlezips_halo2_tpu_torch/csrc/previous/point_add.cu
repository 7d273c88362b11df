// The form of csrc/point_add.cu before its redesign for Hopper (64-bit product,
// see PERF.md), kept verbatim below this comment. chip_smoke.py builds it
// apart from the port's library, beside a copy of csrc/field.cuh, and times
// it beside the redesigned kernel; nothing of the port links or launches it.

// K3's lane-wise form: complete Jacobian point addition over lanes,
// out[i] = p[i] + q[i], points stored as (lanes, 3, 8) rows of X, Y, Z in
// Montgomery form.
//
// Replaces battlezips_halo2_tpu/ops/pallas_kernels.py:414 point_add_T
// (_point_add_T_call) one for one. Identity, P == Q and P == -Q are
// handled by the reference's case order; the doubling runs only in the
// lanes that need it. The MSM no longer runs it: its window aggregation is
// one launch of csrc/window_sums.cu, where one launch of this kernel per
// addition (82 at 256 buckets) was bound by launch latency and by one
// addition's dependent chain (~18 us a launch on the H100). It stays as
// the coordinate-exact cross-check of K6 and as the old route that
// chip_smoke.py times beside the window kernel.
#include "field.cuh"

__global__ void point_add_kernel(FieldConsts F, const uint32_t* p, const uint32_t* q, uint32_t* out,
                                 long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac a = jac_load(p + i * 3 * BZ_NL);
  const Jac b = jac_load(q + i * 3 * BZ_NL);
  jac_store(out + i * 3 * BZ_NL, jac_add(F, a, b));
}

extern "C" int bz_point_add(const uint32_t* consts, const void* p, const void* q, void* out,
                            long long n, void* stream) {
  const FieldConsts F = field_consts(consts);
  const unsigned int block = 128;
  point_add_kernel<<<grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(q),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}
