// M1: the product of a constant Fp matrix and a batch of Fp matrices,
// out[b, j, c] = sum_i W[j, i] a[b, i, c], every element 8 little-endian
// 32-bit limbs: W (K', K), a (B, K, M), out (B, K', M), each contiguous.
// Each term is one Montgomery product W[j, i] a[b, i, c] R^-1 and the sum
// is kept canonical by modular additions, so with W in Montgomery form
// (W R mod p) and a in Montgomery form the result is W a in Montgomery
// form.
//
// Replaces no TPU kernel: it is the port of fp_const_matmul
// (battlezips_halo2_tpu/ops/ntt_mm.py:108), which the reference runs as
// bf16 matrix products on the TPU's MXU (W R and a split into 8-bit chunk
// planes, f32 / i32 sums, the diagonals regrouped, one REDC). The
// matrix-product NTT (ops/ntt_mm.py, BZ_NTT_MM=on) launches it twice per
// NTT: the column DFTs by the (n2, n2) matrix and the row DFTs by the
// (n1, n1) one. No default path launches it.
//
// Bound on the H100: operations. A term needs its 64 wide limb products
// (128 32-bit multiply results) for 64 bytes of input that a tile shares
// between 16 outputs, and an output one reduction, so the integer rate,
// not the memory, bounds it (chip_smoke.py::_m1_bound). This first form
// is the simple one and does about twice that: a full Montgomery product
// (~256 results) and an addition a term; one thread per output element,
// a block computes a 16 x 16 tile of out and walks K in steps of 16,
// staging 16 x 16 elements of W and of a in shared memory (as
// [word][row][column], so a warp's reads and writes fall in distinct
// banks or broadcast), and the carry-chain field ops of field.cuh. Lazy
// reduction (a 512-bit sum, one REDC per output) and the reference's chunk
// planes on the int8 tensor cores are later work.
#define BZ_FE_CARRY_CHAIN
#include "field.cuh"

#define BZ_MM_TILE 16

__global__ void __launch_bounds__(BZ_MM_TILE * BZ_MM_TILE)
    fp_matmul_kernel(FieldConsts F, const uint32_t* __restrict__ w, const uint32_t* __restrict__ a,
                     uint32_t* __restrict__ out, long long batch, int kp, int k, int m) {
  __shared__ uint32_t ws[BZ_NL][BZ_MM_TILE][BZ_MM_TILE];  // W[j0 + row, i0 + column]
  __shared__ uint32_t as[BZ_NL][BZ_MM_TILE][BZ_MM_TILE];  // a[b, i0 + row, c0 + column]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.y * BZ_MM_TILE + ty;  // this thread's output row
  const int c = blockIdx.x * BZ_MM_TILE + tx;  // and column
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const uint32_t* ab = a + b * k * (long long)m * BZ_NL;
    Fe acc = fe_zero();
    for (int i0 = 0; i0 < k; i0 += BZ_MM_TILE) {
      // thread (ty, tx) stages W[j, i0 + tx] and a[b, i0 + ty, c]: a row of
      // 16 threads reads 16 consecutive 32-byte elements of each
      const int wi = i0 + tx, ai = i0 + ty;
      const Fe wv = (j < kp && wi < k) ? fe_load(w + ((long long)j * k + wi) * BZ_NL) : fe_zero();
      const Fe av = (ai < k && c < m) ? fe_load(ab + ((long long)ai * m + c) * BZ_NL) : fe_zero();
#pragma unroll
      for (int v = 0; v < BZ_NL; ++v) {
        ws[v][ty][tx] = wv.v[v];
        as[v][ty][tx] = av.v[v];
      }
      __syncthreads();
      const int terms = min(BZ_MM_TILE, k - i0);
#pragma unroll 1
      for (int t = 0; t < terms; ++t) {
        Fe x, y;
#pragma unroll
        for (int v = 0; v < BZ_NL; ++v) {
          x.v[v] = ws[v][ty][t];
          y.v[v] = as[v][t][tx];
        }
        acc = fe_add(F, acc, fe_mul(F, x, y));
      }
      __syncthreads();
    }
    if (j < kp && c < m) fe_store(out + ((b * kp + j) * (long long)m + c) * BZ_NL, acc);
  }
}

// w: (kp, k) elements, a: (batch, k, m), out: (batch, kp, m), out apart
// from both; every dimension at least 1.
extern "C" int bz_fp_const_matmul(const uint32_t* consts, const void* w, const void* a, void* out, long long batch,
                                  int kp, int k, int m, void* stream) {
  if (batch < 1 || kp < 1 || k < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const FieldConsts F = field_consts(consts);
  const dim3 block(BZ_MM_TILE, BZ_MM_TILE);
  const dim3 grid(grid_for(m, BZ_MM_TILE), grid_for(kp, BZ_MM_TILE),
                  (unsigned int)(batch < 65535 ? batch : 65535));
  fp_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out), batch, kp,
      k, m);
  return (int)cudaGetLastError();
}
