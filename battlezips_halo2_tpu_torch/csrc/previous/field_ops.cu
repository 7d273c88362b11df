// The form of csrc/field_ops.cu before its redesign for Hopper (64-bit product,
// see PERF.md), kept verbatim below this comment. chip_smoke.py builds it
// apart from the port's library, beside a copy of csrc/field.cuh, and times
// it beside the redesigned kernel; nothing of the port links or launches it.

// K1: elementwise field op over rows of 8 x 32-bit limbs,
// out[i] = a[i] (*|+|-) b[i % nb], the product in Montgomery form.
//
// Replaces battlezips_halo2_tpu/ops/pallas_kernels.py:263 mont_mul_rows
// (_mont_mul_call). The same kernel template also serves field add and sub.
// The proof launches it for the Montgomery conversions and the coset and
// inverse-NTT scales (~23 launches a proof); the quotient program, which
// made one launch of it per instruction (~2200 a board proof), runs in one
// launch of csrc/quotient_vm.cu. This kernel still runs that program
// stepwise (ops/gate_eval.py::quotient_vm_plain with op=field_op), the old
// route chip_smoke.py times beside it.
// Bound on the H100: bytes. A product is ~200 integer instructions per
// 96 bytes moved, far under the card's integer rate, so the kernel streams
// rows with 16-byte accesses and keeps no state between threads.
#include "field.cuh"

template <int OP>
__global__ void field_op_kernel(FieldConsts F, const uint32_t* a, const uint32_t* b, uint32_t* out,
                                long long n, long long nb) {  // out may alias a or b
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = fe_load(a + i * BZ_NL);
  const Fe y = fe_load(b + (i % nb) * BZ_NL);
  Fe r;
  if (OP == 0) {
    r = fe_mul(F, x, y);
  } else if (OP == 1) {
    r = fe_add(F, x, y);
  } else {
    r = fe_sub(F, x, y);
  }
  fe_store(out + i * BZ_NL, r);
}

extern "C" int bz_field_op(int op, const uint32_t* consts, const void* a, const void* b, void* out,
                           long long n, long long nb, void* stream) {
  const FieldConsts F = field_consts(consts);
  const unsigned int block = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* po = static_cast<uint32_t*>(out);
  switch (op) {
    case 0:
      field_op_kernel<0><<<grid_for(n, block), block, 0, s>>>(F, pa, pb, po, n, nb);
      break;
    case 1:
      field_op_kernel<1><<<grid_for(n, block), block, 0, s>>>(F, pa, pb, po, n, nb);
      break;
    case 2:
      field_op_kernel<2><<<grid_for(n, block), block, 0, s>>>(F, pa, pb, po, n, nb);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The CUDA runtime's name of a status an entry returned (ops/cuda.py::check).
extern "C" const char* bz_error_name(int status) { return cudaGetErrorName((cudaError_t)status); }
