// K1, the quotient VM: the whole constraint program of a proving key
// (ops/gate_eval.py::emit_vm, instructions (op, a, b, dst) with op 0 = mul,
// 1 = add, 2 = sub over registers 0 = agg, 1..n_pins = pinned inputs, then
// temporaries) over B x ext lanes in one launch, ending in
// h[lane] = agg[lane] * t_inv[i]. One thread runs one lane (b, i).
//
// Replaces the quotient's use of battlezips_halo2_tpu/ops/pallas_kernels.py
// :263 mont_mul_rows (_mont_mul_call), which the reference's device
// evaluator ran once per instruction inside one lax.scan; the port ran it
// as one elementwise launch per instruction (csrc/field_ops.cu), about 2200
// launches per board proof. Here:
//
// - pins are never copied into a register file: a pin descriptor (source,
//   first row, stride along B, stride along the lane, rotation) says where
//   operand (pin p, lane (b, i)) lives, row = row0 + b stride_b +
//   ((i + rot) mod ext) stride_lane in one of four sources (shared
//   fixed/sigma extensions, the batch's extensions, the named constants,
//   the scalar table of constants and challenges). Rotations wrap mod ext;
//   the program never writes a pin;
// - agg and the temporaries live in shared memory as [slot][limb][thread],
//   so a warp's accesses are conflict-free; slot 0 is agg, slot 1 + t is
//   temporary t. Their count is read at launch;
// - every lane runs the same instruction, so the op switch and the operand
//   kind never diverge; the program is read through the read-only cache.
//
// Bound on the H100: operations (the program's Montgomery products over
// every lane). With one lane a thread a board proof (ext 2^15, B = 1) has
// 256 blocks, about 8 warps an SM, and the time is the products' dependent
// chains: about 0.9 us an instruction. Loading the next instruction's pins
// while one computes saved nothing on the H100.
#include "field.cuh"

#define BZ_VM_BLOCK 128
#define BZ_VM_DESC 5  // source, row0, stride_b, stride_lane, rot (int64 each)

__device__ __forceinline__ Fe slot_load(const uint32_t* slots, int slot, int tid) {
  Fe r;
#pragma unroll
  for (int w = 0; w < BZ_NL; ++w) r.v[w] = slots[(slot * BZ_NL + w) * BZ_VM_BLOCK + tid];
  return r;
}

__device__ __forceinline__ void slot_store(uint32_t* slots, int slot, int tid, const Fe& x) {
#pragma unroll
  for (int w = 0; w < BZ_NL; ++w) slots[(slot * BZ_NL + w) * BZ_VM_BLOCK + tid] = x.v[w];
}

__global__ void __launch_bounds__(BZ_VM_BLOCK)
    quotient_vm_kernel(FieldConsts F, const int4* __restrict__ prog, int n_instr,
                       const long long* __restrict__ desc, int n_pins, const uint32_t* __restrict__ src0,
                       const uint32_t* __restrict__ src1, const uint32_t* __restrict__ src2,
                       const uint32_t* __restrict__ src3, const uint32_t* __restrict__ t_inv,
                       uint32_t* __restrict__ out, int log_ext, long long lanes) {
  extern __shared__ uint32_t slots[];
  const int tid = threadIdx.x;
  const long long lane = (long long)blockIdx.x * BZ_VM_BLOCK + tid;
  if (lane >= lanes) return;  // no barrier follows
  const long long mask = (1LL << log_ext) - 1;
  const long long b = lane >> log_ext;
  const long long i = lane & mask;

  auto operand = [&](int reg) -> Fe {
    if (reg == 0 || reg > n_pins) return slot_load(slots, reg == 0 ? 0 : reg - n_pins, tid);
    const long long* d = desc + (long long)(reg - 1) * BZ_VM_DESC;
    const long long s = __ldg(d);
    const uint32_t* base = s == 0 ? src0 : s == 1 ? src1 : s == 2 ? src2 : src3;
    const long long row = __ldg(d + 1) + b * __ldg(d + 2) + ((i + __ldg(d + 4)) & mask) * __ldg(d + 3);
    return fe_load(base + row * BZ_NL);
  };

  slot_store(slots, 0, tid, fe_zero());
  for (int k = 0; k < n_instr; ++k) {
    const int4 ins = __ldg(prog + k);
    const Fe x = operand(ins.y);
    const Fe y = operand(ins.z);
    Fe r;
    if (ins.x == 0) {
      r = fe_mul(F, x, y);
    } else if (ins.x == 1) {
      r = fe_add(F, x, y);
    } else {
      r = fe_sub(F, x, y);
    }
    slot_store(slots, ins.w == 0 ? 0 : ins.w - n_pins, tid, r);
  }
  fe_store(out + lane * BZ_NL, fe_mul(F, slot_load(slots, 0, tid), fe_load(t_inv + i * BZ_NL)));
}

extern "C" int bz_quotient_vm(const uint32_t* consts, const void* prog, int n_instr, const void* desc, int n_pins,
                              const void* src0, const void* src1, const void* src2, const void* src3,
                              const void* t_inv, void* out, int log_ext, long long lanes, int n_temps,
                              void* stream) {
  const size_t smem = (size_t)(n_temps + 1) * BZ_NL * BZ_VM_BLOCK * sizeof(uint32_t);
  if (n_temps < 0 || log_ext < 0 || log_ext > 40) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(quotient_vm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const FieldConsts F = field_consts(consts);
  const unsigned int grid = grid_for(lanes, BZ_VM_BLOCK);
  quotient_vm_kernel<<<grid, BZ_VM_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const int4*>(prog), n_instr, static_cast<const long long*>(desc), n_pins,
      static_cast<const uint32_t*>(src0), static_cast<const uint32_t*>(src1), static_cast<const uint32_t*>(src2),
      static_cast<const uint32_t*>(src3), static_cast<const uint32_t*>(t_inv), static_cast<uint32_t*>(out), log_ext,
      lanes);
  return (int)cudaGetLastError();
}
