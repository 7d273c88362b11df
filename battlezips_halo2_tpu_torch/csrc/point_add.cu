// The lane-wise point additions, complete Jacobian addition over lanes
// with the points in Montgomery form: K3's forms, points stored as
// (lanes, 3, 8) rows of X, Y, Z, out[i] = p[i] + q[i] (bz_point_add) and
// the left-to-right fold of a stack of D partial sums,
// out[i] = ((s[0][i] + s[1][i]) + s[2][i]) + ... (bz_point_fold); and K6's
// form on coordinate planes, (3, lanes, 8) with the X, Y and Z planes each
// contiguous (bz_point_add_planes).
//
// K3's replace battlezips_halo2_tpu/ops/pallas_kernels.py:414 point_add_T
// (_point_add_T_call): bz_point_add one for one, bz_point_fold the
// reference's loop of D - 1 point_add calls over the all-gathered window-sum
// partials of the sharded MSM (battlezips_halo2_tpu/parallel/msm.py:51-54),
// in the same order, so the Jacobian coordinates equal the reference's.
// bz_point_add_planes replaces the lane-wise use of
// battlezips_halo2_tpu/ops/pallas_kernels.py:167 point_add_rows
// (_point_add_call), the reference's addition over X, Y and Z rows; the
// window aggregation K6 runs in the MSM is csrc/point_add_planes.cu.
// Identity, P == Q and P == -Q are handled by the reference's case order,
// so every form gives the same coordinates as the others and as the plain
// versions; the doubling runs only in the lanes that need it.
//
// Who launches them: the sharded MSM (parallel/msm.py) folds its partials
// with one bz_point_fold a commit batch (8 a sharded board proof at any
// number of shards D). bz_point_add and bz_point_add_planes are the
// coordinate-exact cross-checks of each other and of the window kernels,
// and the old route that chip_smoke.py times beside those (one launch per
// addition, 82 at 256 buckets, was bound by launch latency).
//
// Bound on the H100: at the fold's few hundred lanes (11 x 32 windows of a
// board commit batch), one lane's dependent chain of D - 1 additions, far
// from the card's memory or integer rate; at 2^17 lanes and more, the
// integer rate (about 16 Montgomery products an addition for 192 bytes).
// So the design keeps a lane's sum in registers across the D - 1 additions
// (one launch, where the fold was D - 1 launches), takes the carry-chain
// field ops of field.cuh (an addition's chain of 16 products is latency:
// the 64-bit product's carries made K8's step 2.7x as many SASS
// instructions), and spreads the lanes over as many SMs as it can: the
// caller sizes every form's blocks from the lane count
// (ops/cuda.py::chain_grid: 352 lanes in 11 blocks of 32, 1528 in 48
// of 32, 2^17 in 512 of 256). A warp's lanes read 32 consecutive 32-byte
// rows of each plane, every byte of the sectors it touches.
#define BZ_FE_CARRY_CHAIN
#include "field.cuh"

// Lane i of n: p[i] + q[i], points interleaved (n, 3, 8) (K3) or, PLANAR,
// as planes (3, n, 8) (K6); out may alias p or q.
template <bool PLANAR>
__global__ void point_add_kernel(FieldConsts F, const uint32_t* p, const uint32_t* q, uint32_t* out,
                                 long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac r = jac_add(F, jac_load_at<PLANAR>(p, i, n), jac_load_at<PLANAR>(q, i, n));
  jac_store_at<PLANAR>(out, i, n, r);
}

__global__ void point_fold_kernel(FieldConsts F, const uint32_t* stack, uint32_t* out, int d, long long lanes) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  Jac acc = jac_load(stack + i * 3 * BZ_NL);
  for (int k = 1; k < d; ++k) acc = jac_add(F, acc, jac_load(stack + (k * lanes + i) * 3 * BZ_NL));
  jac_store(out + i * 3 * BZ_NL, acc);
}

template <bool PLANAR>
static int launch_point_add(const uint32_t* consts, const void* p, const void* q, void* out, long long n,
                            int threads, void* stream) {
  if (threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  const FieldConsts F = field_consts(consts);
  point_add_kernel<PLANAR><<<grid_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(q), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

// p, q, out: (n, 3, 8); out may be p or q.
extern "C" int bz_point_add(const uint32_t* consts, const void* p, const void* q, void* out, long long n,
                            int threads, void* stream) {
  return launch_point_add<false>(consts, p, q, out, n, threads, stream);
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

// p, q, out: (3, n, 8) planes; out may be p or q.
extern "C" int bz_point_add_planes(const uint32_t* consts, const void* p, const void* q, void* out, long long n,
                                   int threads, void* stream) {
  return launch_point_add<true>(consts, p, q, out, n, threads, stream);
}
