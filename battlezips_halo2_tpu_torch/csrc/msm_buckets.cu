// K2 and K7: Pippenger bucket accumulation as a balanced chunked walk with
// a boundary merge. The rows of a batch of MSMs are sorted by bucket
// (ops/msm.py::bucket_runs): row i adds the affine point table[src[i]] to
// bucket bid[i], and bucket b owns rows [starts[b], starts[b+1]).
//
// Replaces battlezips_halo2_tpu/ops/pallas_kernels.py:365 msm_step_T
// (_msm_step_T_call, incomplete mixed add with the needs_double flag: K2)
// and :227 msm_step_rows (_mixed_step_call, complete mixed add: K7, the
// COMPLETE variant here). On the TPU a lax.scan launched one step for every
// lane, each lane owning an equal run of sorted rows, and repaired the
// segments that span a lane boundary afterwards. Here one C call
// (bz_msm_buckets) puts three kernels on the stream:
//
// 0. bucket_layout_kernel (one block) reads the pass's rows, starts[nb],
//    and its longest run, and sets the chunk length
//    L = max(ceil(rows / resident), ceil(longest / BZ_MB_SPAN), 1), with
//    resident one wave of phase A's blocks from the CUDA occupancy
//    calculator (bz_msm_bucket_resident; ops/msm.py::bucket_layout is the
//    same formula).
// A. bucket_chunks_kernel: thread t walks rows [t L, (t+1) L) with the
//    running sum in registers, jac_lift at the head of each bucket's segment
//    and jac_add_mixed<COMPLETE> after it. A segment that begins and ends
//    inside the chunk is its bucket's whole run and is written to out[b];
//    the chunk's first segment, if the chunk begins inside a bucket, goes
//    to carry slot 2t, and its last, if the bucket runs on past the chunk,
//    to slot 2t + 1, each with its P == Q flag. The same threads write the
//    identity to the empty buckets.
// B. bucket_merge_kernel: one thread for every boundary t L that lies
//    inside a bucket whose run starts in chunk t - 1 (its first boundary):
//    it adds slot 2(t-1) + 1 and then slot 2u of every later chunk u the
//    run reaches, in chunk order, with the complete jac_add, and writes the
//    bucket and the OR of its pieces' flags. A run over k chunks costs
//    k - 1 complete additions; a P then P pair split by a boundary meets
//    the complete law there and raises no flag, which is right.
//
// A launch waits for its slowest thread: with one thread per bucket, for
// the longest run and, where there are more buckets than resident threads
// (the board's commit batches), for a second wave. Equal chunks in one
// wave make every thread of phase A at most L additions deep, so the SMs
// run full and the runs' spread does not set the time. Phase B is as deep
// as the most chunks one run spans, and its additions are complete ones,
// about three times a mixed addition's latency on the H100 (PERF.md §6):
// at an IPA round one wave alone gives L = 2, and the top window's runs of
// ~50 rows (its digits reach only 2^(255 - 248)) would cross 24 chunks.
// The floor ceil(longest / BZ_MB_SPAN) keeps every merge at most
// BZ_MB_SPAN additions deep.
//
// The point additions call one out-of-line Montgomery product
// (BZ_FE_MUL_CALL): 96 registers instead of 126, 5 blocks of 128 an SM
// instead of 4, and a shorter chain per addition (PERF.md §6).
//
// Points come from a table of affine (x, y) rows in Montgomery form, the
// all-zero row being the identity ((0, 0) is not on y^2 = x^3 + 5). Bound
// on the H100: operations, about 11 Montgomery products per row after its
// bucket's head (chip_smoke.py::bound_ms counts them at the 32-bit
// multiply rate, 64 results per SM per clock), against 72 bytes read per
// row.
#define BZ_FE_MUL_CALL
#include "field.cuh"

#define BZ_MB_BLOCK 128
#define BZ_MB_LAYOUT_BLOCK 1024
// A run is cut into at most about this many chunks (ops/msm.py::BUCKET_SPAN).
#define BZ_MB_SPAN 4

// The pass's chunk length, from its rows (starts[nb]) and its longest run:
// L = max(ceil(rows / resident), ceil(longest / BZ_MB_SPAN), 1), written to
// layout[0]. One block; ops/msm.py::bucket_layout is the same formula.
__global__ void __launch_bounds__(BZ_MB_LAYOUT_BLOCK)
    bucket_layout_kernel(const int32_t* __restrict__ starts, long long nb, long long resident,
                         long long* __restrict__ layout) {
  __shared__ int32_t warp_max[BZ_MB_LAYOUT_BLOCK / 32];
  int32_t longest = 0;
  for (long long b = threadIdx.x; b < nb; b += BZ_MB_LAYOUT_BLOCK) longest = max(longest, starts[b + 1] - starts[b]);
  for (int d = 16; d >= 1; d >>= 1) longest = max(longest, __shfl_xor_sync(0xffffffffu, longest, d));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = longest;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < BZ_MB_LAYOUT_BLOCK / 32; ++w) longest = max(longest, warp_max[w]);
    const long long rows = starts[nb];
    long long len = (rows + resident - 1) / resident;
    len = max(len, ((long long)longest + BZ_MB_SPAN - 1) / BZ_MB_SPAN);
    layout[0] = max(len, 1LL);
  }
}

// A finished segment of bucket b in chunk t: the chunk's first segment when
// the chunk began inside b's run (head), else its last when b's run goes on
// past the chunk (tail), else b's whole run.
__device__ __forceinline__ void emit_segment(const Jac& acc, bool flag, int32_t b, long long t, bool head, bool tail,
                                             uint32_t* out, int32_t* flags, uint32_t* carry,
                                             int32_t* carry_flags) {
  const long long slot = head ? 2 * t : 2 * t + 1;
  if (head || tail) {
    jac_store(carry + slot * 3 * BZ_NL, acc);
    carry_flags[slot] = flag;
  } else {
    jac_store(out + (long long)b * 3 * BZ_NL, acc);
    flags[b] = flag;
  }
}

template <bool COMPLETE>
__global__ void __launch_bounds__(BZ_MB_BLOCK)
    bucket_chunks_kernel(FieldConsts F, const uint32_t* __restrict__ table, const int32_t* __restrict__ src,
                         const int32_t* __restrict__ bid, const int32_t* __restrict__ starts,
                         uint32_t* __restrict__ out, int32_t* __restrict__ flags, uint32_t* __restrict__ carry,
                         int32_t* __restrict__ carry_flags, const long long* __restrict__ layout, long long nb,
                         long long threads) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = t; b < nb; b += stride) {
    if (starts[b] == starts[b + 1]) {
      jac_store(out + b * 3 * BZ_NL, jac_infinity(F));
      flags[b] = 0;
    }
  }
  const long long rows = starts[nb];
  const long long len = layout[0];
  const long long lo = t * len;
  if (t >= threads || lo >= rows) return;
  const long long hi = lo + len < rows ? lo + len : rows;

  int32_t cur = bid[lo];
  const bool head_in = lo > 0 && bid[lo - 1] == cur;  // the chunk begins inside cur's run
  bool first = true;
  bool flag = false;
  Jac acc = jac_infinity(F);
  for (long long i = lo; i < hi; ++i) {
    const int32_t b = bid[i];
    const uint32_t* row = table + (long long)src[i] * 2 * BZ_NL;
    const Fe x = fe_load(row);
    const Fe y = fe_load(row + BZ_NL);
    const bool inf = fe_is_zero(x) && fe_is_zero(y);
    if (i == lo || b != cur) {
      if (i != lo) {  // cur's segment ended at row i - 1
        emit_segment(acc, flag, cur, t, first && head_in, false, out, flags, carry, carry_flags);
        first = false;
        cur = b;
      }
      acc = jac_lift(F, x, y, inf);
      flag = false;
    } else {
      bool nd;
      acc = jac_add_mixed<COMPLETE>(F, acc, x, y, inf, nd);
      flag = flag || nd;
    }
  }
  const bool tail = hi < rows && bid[hi] == cur;
  emit_segment(acc, flag, cur, t, first && head_in, tail, out, flags, carry, carry_flags);
}

__global__ void __launch_bounds__(BZ_MB_BLOCK)
    bucket_merge_kernel(FieldConsts F, const int32_t* __restrict__ bid, const int32_t* __restrict__ starts,
                        uint32_t* __restrict__ out, int32_t* __restrict__ flags, const uint32_t* __restrict__ carry,
                        const int32_t* __restrict__ carry_flags, const long long* __restrict__ layout,
                        long long nb, long long threads) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x + 1;  // the boundary between chunks t - 1, t
  const long long rows = starts[nb];
  const long long len = layout[0];
  if (t >= threads || t * len >= rows) return;
  const int32_t b = bid[t * len];
  if (bid[t * len - 1] != b || starts[b] < (t - 1) * len) return;  // no run crosses, or not its first boundary
  const long long end = starts[b + 1];
  Jac acc = jac_load(carry + (2 * t - 1) * 3 * BZ_NL);
  bool flag = carry_flags[2 * t - 1] != 0;
  for (long long u = t; u * len < end; ++u) {
    acc = jac_add(F, acc, jac_load(carry + 2 * u * 3 * BZ_NL));
    flag = flag || carry_flags[2 * u] != 0;
  }
  jac_store(out + (long long)b * 3 * BZ_NL, acc);
  flags[b] = flag;
}

// resident: the threads of one wave (bz_msm_bucket_resident), which set the
// chunk length; threads: those launched, at most resident and at least the
// chunks (the wrapper passes min(resident, sorted rows)); carry and
// carry_flags hold 2 threads slots, layout one long long.
extern "C" int bz_msm_buckets(const uint32_t* consts, int complete, const void* table, const void* src,
                              const void* bid, const void* starts, void* out, void* flags, void* carry,
                              void* carry_flags, void* layout, long long nb, long long resident,
                              long long threads, void* stream) {
  if (threads < 1 || resident < threads) return (int)cudaErrorInvalidValue;
  const FieldConsts F = field_consts(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* tb = static_cast<const uint32_t*>(table);
  const int32_t* sr = static_cast<const int32_t*>(src);
  const int32_t* bi = static_cast<const int32_t*>(bid);
  const int32_t* st = static_cast<const int32_t*>(starts);
  uint32_t* o = static_cast<uint32_t*>(out);
  int32_t* f = static_cast<int32_t*>(flags);
  uint32_t* c = static_cast<uint32_t*>(carry);
  int32_t* cf = static_cast<int32_t*>(carry_flags);
  long long* lay = static_cast<long long*>(layout);
  bucket_layout_kernel<<<1, BZ_MB_LAYOUT_BLOCK, 0, s>>>(st, nb, resident, lay);
  const unsigned int grid = grid_for(threads, BZ_MB_BLOCK);
  if (complete) {
    bucket_chunks_kernel<true><<<grid, BZ_MB_BLOCK, 0, s>>>(F, tb, sr, bi, st, o, f, c, cf, lay, nb, threads);
  } else {
    bucket_chunks_kernel<false><<<grid, BZ_MB_BLOCK, 0, s>>>(F, tb, sr, bi, st, o, f, c, cf, lay, nb, threads);
  }
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && threads > 1) {
    bucket_merge_kernel<<<grid_for(threads - 1, BZ_MB_BLOCK), BZ_MB_BLOCK, 0, s>>>(F, bi, st, o, f, c, cf, lay, nb,
                                                                                    threads);
    e = cudaGetLastError();
  }
  return (int)e;
}

// Threads of phase A (bucket_chunks_kernel<complete>) the current card holds
// at once: its SMs times the blocks an SM keeps resident (from the kernel's
// registers), times the block. ops/msm.py::bucket_resident asks once per
// card and variant; the chunk length follows from it.
extern "C" int bz_msm_bucket_resident(int complete, long long* threads) {
  int device = 0, sms = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = complete ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bucket_chunks_kernel<true>, BZ_MB_BLOCK, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bucket_chunks_kernel<false>, BZ_MB_BLOCK, 0);
  }
  *threads = (long long)sms * blocks * BZ_MB_BLOCK;
  return (int)e;
}
