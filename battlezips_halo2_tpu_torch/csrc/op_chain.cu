// K9: a chained field-op probe. Per element i, x = a[i], then reps times
// x = op(x, b[i]); out[i] = x. The ops with a field value are the
// Montgomery product (0), add (1), sub (2) and Montgomery reduction
// x -> x R^-1 (3); a wrapping limb-wise 32-bit add (4) and no op (5) time
// the memory floor and the launch floor.
//
// Replaces tools/exp_step_t.py:210 _op_chain_call (launched at :287 by
// kernel_micro, :298), a latency probe of the TPU's 16-bit limb arithmetic.
// Its mul32 / mul32raw / c16 / mulraw / rawi32 ops time 16-bit limb
// mechanics that 8 x 32-bit limbs do not have; mul32 has mul's value.
// Bound on the H100: operations for the field ops (the chain is one
// thread's dependent sequence, 64 bytes read and 32 written per element),
// bytes for raw and noop. 2^15 threads are ~2 warps a scheduler, so the
// field ops take the carry-chain forms of field.cuh (BZ_FE_CARRY_CHAIN:
// a product is two independent carry chains), and the host's plan
// (ops/cuda.py::chain_grid) sizes blocks so that every SM gets one.
#define BZ_FE_CARRY_CHAIN
#include "field.cuh"

template <int OP>
__global__ void op_chain_kernel(FieldConsts F, const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, uint32_t* out, long long n,
                                int reps) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = fe_load(a + i * BZ_NL);
  const Fe y = fe_load(b + i * BZ_NL);
  for (int r = 0; r < reps; ++r) {
    if (OP == 0) {
      x = fe_mul(F, x, y);
    } else if (OP == 1) {
      x = fe_add(F, x, y);
    } else if (OP == 2) {
      x = fe_sub(F, x, y);
    } else if (OP == 3) {
      x = fe_redc(F, x);
    } else if (OP == 4) {
#pragma unroll
      for (int j = 0; j < BZ_NL; ++j) x.v[j] += y.v[j];
    }
  }
  fe_store(out + i * BZ_NL, x);
}

// block: threads a block, from the host's plan (ops/cuda.py::chain_grid)
extern "C" int bz_op_chain(int op, const uint32_t* consts, const void* a, const void* b, void* out,
                           long long n, int reps, int block, void* stream) {
  const FieldConsts F = field_consts(consts);
  const unsigned int grid = grid_for(n, block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* po = static_cast<uint32_t*>(out);
  switch (op) {
    case 0: op_chain_kernel<0><<<grid, block, 0, s>>>(F, pa, pb, po, n, reps); break;
    case 1: op_chain_kernel<1><<<grid, block, 0, s>>>(F, pa, pb, po, n, reps); break;
    case 2: op_chain_kernel<2><<<grid, block, 0, s>>>(F, pa, pb, po, n, reps); break;
    case 3: op_chain_kernel<3><<<grid, block, 0, s>>>(F, pa, pb, po, n, reps); break;
    case 4: op_chain_kernel<4><<<grid, block, 0, s>>>(F, pa, pb, po, n, reps); break;
    case 5: op_chain_kernel<5><<<grid, block, 0, s>>>(F, pa, pb, po, n, reps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
