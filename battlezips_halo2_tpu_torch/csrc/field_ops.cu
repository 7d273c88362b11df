// K1: elementwise field op over rows of 8 x 32-bit limbs,
// out[r nb + c] = a[r nb + c] (*|+|-) b[c] for c < nb and r < n / nb (b is
// broadcast over a's batch), the product in Montgomery form.
//
// Replaces battlezips_halo2_tpu/ops/pallas_kernels.py:263 mont_mul_rows
// (_mont_mul_call). The same kernel template also serves field add and sub.
// The proof launches it for the basis transforms' scales: one product before
// or after each NTT, the Montgomery conversions folded into the scale vector
// (poly/transforms.py), so 6 launches a steady board proof (one per
// commitment batch's iNTT and two for the quotient's extensions), and one
// per shard and scale in a sharded transform (parallel/ntt.py). The
// quotient program runs in one launch of csrc/quotient_vm.cu; this kernel
// still runs that program stepwise (ops/gate_eval.py::quotient_vm_plain with
// op=field_op), the old route chip_smoke.py times beside it.
//
// Bound on the H100: bytes at the proof's shapes. A product reads 64 bytes
// (a and the broadcast b, which stays in L2) and writes 32, against 256
// 32-bit multiply results, under the card's integer rate. So the kernel
// streams rows: one element a thread, 16-byte accesses, the carry-chain
// field ops of field.cuh (fewer instructions than the 64-bit product's,
// whose carries took K8's step from 2568 to 6824 SASS instructions), and
// a 2-D grid, x over b's rows and y over the batch, so a thread finds its b
// row without a 64-bit division and loads it once for all its batch rows.
// The caller picks the block size (fields/limb.py::FIELD_OP_THREADS, 128,
// the fastest measured: blocks of 512 or more leave warps unresident).
#define BZ_FE_CARRY_CHAIN
#include "field.cuh"

template <int OP>
__global__ void field_op_kernel(FieldConsts F, const uint32_t* a, const uint32_t* b, uint32_t* out,
                                long long nb, long long batch) {  // out may alias a or b
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= nb) return;
  const Fe y = fe_load(b + c * BZ_NL);
  const long long step = (long long)gridDim.y * blockDim.y;
  for (long long r = blockIdx.y * (long long)blockDim.y + threadIdx.y; r < batch; r += step) {
    const long long i = (r * nb + c) * BZ_NL;
    const Fe x = fe_load(a + i);
    Fe res;
    if (OP == 0) {
      res = fe_mul(F, x, y);
    } else if (OP == 1) {
      res = fe_add(F, x, y);
    } else {
      res = fe_sub(F, x, y);
    }
    fe_store(out + i, res);
  }
}

// n rows of a, nb rows of b (nb divides n), threads a block (a power of two
// up to 1024). A block is bx x by threads, bx = min(threads, nb rounded up
// to a power of two): with nb = 1 a warp covers 32 consecutive rows of a.
// gridDim.y stops at 65535; the y loop covers a longer batch.
extern "C" int bz_field_op(int op, const uint32_t* consts, const void* a, const void* b, void* out,
                           long long n, long long nb, int threads, void* stream) {
  if (nb <= 0 || n % nb || threads <= 0 || threads > 1024 || (threads & (threads - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const FieldConsts F = field_consts(consts);
  const long long batch = n / nb;
  unsigned int bx = 1;
  while (bx < (unsigned int)threads && bx < nb) bx *= 2;
  const dim3 block(bx, (unsigned int)threads / bx);
  const long long gy = (batch + block.y - 1) / block.y;
  const dim3 grid(grid_for(nb, bx), (unsigned int)(gy < 65535 ? gy : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* po = static_cast<uint32_t*>(out);
  switch (op) {
    case 0:
      field_op_kernel<0><<<grid, block, 0, s>>>(F, pa, pb, po, nb, batch);
      break;
    case 1:
      field_op_kernel<1><<<grid, block, 0, s>>>(F, pa, pb, po, nb, batch);
      break;
    case 2:
      field_op_kernel<2><<<grid, block, 0, s>>>(F, pa, pb, po, nb, batch);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The CUDA runtime's name of a status an entry returned (ops/cuda.py::check).
extern "C" const char* bz_error_name(int status) { return cudaGetErrorName((cudaError_t)status); }
