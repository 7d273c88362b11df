// K3's lane-wise forms: complete Jacobian point addition over lanes,
// out[i] = p[i] + q[i] (bz_point_add), and the left-to-right fold of a
// stack of D partial sums, out[i] = ((s[0][i] + s[1][i]) + s[2][i]) + ...
// (bz_point_fold), points stored as (lanes, 3, 8) rows of X, Y, Z in
// Montgomery form.
//
// Replaces battlezips_halo2_tpu/ops/pallas_kernels.py:414 point_add_T
// (_point_add_T_call): bz_point_add one for one, bz_point_fold the
// reference's loop of D - 1 point_add calls over the all-gathered window-sum
// partials of the sharded MSM (battlezips_halo2_tpu/parallel/msm.py:51-54),
// in the same order, so the Jacobian coordinates equal the reference's.
// Identity, P == Q and P == -Q are handled by the reference's case order;
// the doubling runs only in the lanes that need it.
//
// Who launches them: the sharded MSM (parallel/msm.py) folds its partials
// with one bz_point_fold a commit batch (8 a sharded board proof at any
// number of shards D). bz_point_add is the coordinate-exact cross-check of
// K6 and the old route that chip_smoke.py times beside the window kernel
// (csrc/window_sums.cu, one launch per bucket pass: one launch of this
// kernel per addition, 82 at 256 buckets, was bound by launch latency).
//
// Bound on the H100: at the fold's few hundred lanes (11 x 32 windows of a
// board commit batch), one lane's dependent chain of D - 1 additions, far
// from the card's memory or integer rate. So the design keeps a lane's sum
// in registers across the D - 1 additions (one launch, where the fold was
// D - 1 launches), takes the carry-chain field ops of field.cuh (an
// addition's chain of 16 products is latency: the 64-bit product's carries
// made K8's step 2.7x as many SASS instructions), and spreads the lanes
// over as many SMs as it can: the caller sizes the blocks from the lane
// count (ops/cuda.py::chain_grid: 352 lanes in 11 blocks of 32).
#define BZ_FE_CARRY_CHAIN
#include "field.cuh"

__global__ void point_add_kernel(FieldConsts F, const uint32_t* p, const uint32_t* q, uint32_t* out,
                                 long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac a = jac_load(p + i * 3 * BZ_NL);
  const Jac b = jac_load(q + i * 3 * BZ_NL);
  jac_store(out + i * 3 * BZ_NL, jac_add(F, a, b));
}

__global__ void point_fold_kernel(FieldConsts F, const uint32_t* stack, uint32_t* out, int d, long long lanes) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  Jac acc = jac_load(stack + i * 3 * BZ_NL);
  for (int k = 1; k < d; ++k) acc = jac_add(F, acc, jac_load(stack + (k * lanes + i) * 3 * BZ_NL));
  jac_store(out + i * 3 * BZ_NL, acc);
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

// stack: (d, lanes, 3, 8), d >= 1; out: (lanes, 3, 8), not inside stack.
extern "C" int bz_point_fold(const uint32_t* consts, const void* stack, void* out, int d, long long lanes,
                             int threads, void* stream) {
  if (d < 1 || threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  const FieldConsts F = field_consts(consts);
  point_fold_kernel<<<grid_for(lanes, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const uint32_t*>(stack), static_cast<uint32_t*>(out), d, lanes);
  return (int)cudaGetLastError();
}
