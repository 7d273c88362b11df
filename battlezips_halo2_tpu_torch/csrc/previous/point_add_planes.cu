// K6's lane-wise kernel as it was before its redesign for Hopper (the
// 64-bit product, called out of line; blocks of 128 whatever the lane
// count; see PERF.md), kept verbatim below this comment with the define
// and the include it had in csrc/point_add_planes.cu, whose window kernel
// stays there unchanged. chip_smoke.py builds it apart from the port's
// library, beside copies of csrc/field.cuh and csrc/window_body.cuh, and
// times it beside the redesigned kernel (csrc/point_add.cu); nothing of
// the port links or launches it.
#define BZ_FE_MUL_CALL
#include "window_body.cuh"

__global__ void point_add_planes_kernel(FieldConsts F, const uint32_t* p, const uint32_t* q,
                                        uint32_t* out, long long n) {  // out may alias p or q
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac r = jac_add(F, jac_load_at<true>(p, i, n), jac_load_at<true>(q, i, n));
  jac_store_at<true>(out, i, n, r);
}

extern "C" int bz_point_add_planes(const uint32_t* consts, const void* p, const void* q, void* out,
                                   long long n, void* stream) {
  const FieldConsts F = field_consts(consts);
  const unsigned int block = 128;
  point_add_planes_kernel<<<grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(q),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

