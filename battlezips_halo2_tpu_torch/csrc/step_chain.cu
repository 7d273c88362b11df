// K8: the chained MSM bucket step. Per lane i and step s,
//   acc_i = heads[s][i] ? lift(P_i) : acc_i + P_i,
// with P_i a fixed affine point (Montgomery (x, y) row, all-zero = the
// identity) and the INCOMPLETE mixed addition of K2 with its collision flag
// dropped. acc is updated in place over steps [s0, s1).
//
// Replaces tools/exp_step_t.py:110 _step_T_call (launched at :138 once per
// step inside the lax.scan of chain_pallas_T, :150). Here one thread holds
// its lane's acc in registers across the whole chain, so a call over all
// steps reads P and acc once and writes acc once; s1 - s0 = 1 gives the
// reference's dataflow of one launch per step.
//
// The excluded case of the incomplete law is reached on purpose: on the
// first step after a head acc = lift(P), so acc + P has h = r = 0 and the
// generic formula returns (0, 0, 0), which the next step treats as the
// identity (Z = 0). The device function is K2's (jac_add_mixed<false> in
// field.cuh), so these bits equal the reference's, not a doubling.
//
// Bound on the H100: operations (11 Montgomery products per add against
// 1 byte of head per step). 2^15 lanes are ~2 warps a scheduler, each a
// chain of dependent products, so the product's latency and instruction
// count set the time. The field ops are field.cuh's carry chains
// (BZ_FE_CARRY_CHAIN): a step is ~2600 SASS instructions inlined, against
// ~6800 with the 64-bit product, and runs 2.5x faster. Taking the
// addition's independent products in pairs, loading the next step's head
// ahead, and the product out of line (BZ_FE_MUL_CALL) gained nothing or
// lost on the H100 (PERF.md §6).
#define BZ_FE_CARRY_CHAIN
#include "field.cuh"

__global__ void step_chain_kernel(FieldConsts F, uint32_t* acc, const uint32_t* __restrict__ pxy,
                                  const uint8_t* __restrict__ heads, long long n, int s0, int s1) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = fe_load(pxy + i * 2 * BZ_NL);
  const Fe y = fe_load(pxy + i * 2 * BZ_NL + BZ_NL);
  const bool inf = fe_is_zero(x) && fe_is_zero(y);
  Jac a = jac_load(acc + i * 3 * BZ_NL);
  for (int s = s0; s < s1; ++s) {
    if (heads[(long long)s * n + i]) {
      a = jac_lift(F, x, y, inf);
    } else {
      bool unused;
      a = jac_add_mixed<false>(F, a, x, y, inf, unused);
    }
  }
  jac_store(acc + i * 3 * BZ_NL, a);
}

// block: threads a block, from the host's plan (ops/cuda.py::chain_grid)
extern "C" int bz_step_chain(const uint32_t* consts, void* acc, const void* pxy, const void* heads,
                             long long n, int s0, int s1, int block, void* stream) {
  const FieldConsts F = field_consts(consts);
  step_chain_kernel<<<grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(pxy),
      static_cast<const uint8_t*>(heads), n, s0, s1);
  return (int)cudaGetLastError();
}
