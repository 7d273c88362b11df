// The window aggregation of Pippenger's MSM, one launch per bucket pass:
// for every row of bucket sums S_0 .. S_m (S_0 unused), T = sum_{b=1..m}
// b S_b. One body serves two kernels that differ only in how a point is
// addressed: K3 (csrc/window_sums.cu) over interleaved points, K6
// (csrc/point_add_planes.cu) over coordinate planes. Each source defines
// its own __global__ around the body, so each chooses its own Montgomery
// product (BZ_FE_MUL_CALL, csrc/field.cuh).
//
// The reference launched one addition of its two-level running sums at a
// time (ops/msm.py, about 2 (g + G) launches deep, 82 at m = 255). Here the
// whole aggregation of a row runs inside one block, with the points in
// registers and shared memory:
//
// 1. a row's buckets are split over `threads` threads (a power of two, up
//    to a block of 128), thread t taking the segment b = t s + j, j = 1..s
//    (s a power of two; buckets past m are the identity). Walking its
//    segment from the top, it keeps U_t = sum_j S_{ts+j} and
//    A_t = sum_j j S_{ts+j}: 2 s additions;
// 2. since T = s sum_t t U_t + sum_t A_t and sum_t t U_t = sum_{t>=1}
//    suffix_t with suffix_t = sum_{t'>=t} U_t', an inclusive suffix scan
//    of U over the row's threads (log2 threads steps through shared
//    memory) gives each thread its suffix_t;
// 3. each thread forms z_t = s suffix_t + A_t (suffix_0 left out) with
//    log2 s doublings, and a tree reduction (log2 threads steps) sums z_t.
//
// Serial depth: 2 s + 2 log2 threads + log2 s + 1 additions, 20 at m = 255
// with 128 threads. The additions are jac_add (complete: the identity,
// P == Q and P == -Q select their case), so padding and equal or opposite
// buckets need nothing special. The order of additions differs from the
// reference's, so the Jacobian coordinates differ while the points are
// equal: compare affine.
//
// Shared memory holds one point per thread as [word][thread], so a warp's
// accesses fall in 32 different banks. Bound on the H100: operations, about
// 16 Montgomery products per addition; at the proof's widths (tens to
// thousands of rows) the serial depth and the launch decide the time.
#pragma once

#include "field.cuh"

#define BZ_WS_BLOCK 128

__device__ __forceinline__ void jac_to_shared(uint32_t* buf, int tid, const Jac& p) {
#pragma unroll
  for (int w = 0; w < BZ_NL; ++w) {
    buf[w * BZ_WS_BLOCK + tid] = p.x.v[w];
    buf[(BZ_NL + w) * BZ_WS_BLOCK + tid] = p.y.v[w];
    buf[(2 * BZ_NL + w) * BZ_WS_BLOCK + tid] = p.z.v[w];
  }
}

__device__ __forceinline__ Jac jac_from_shared(const uint32_t* buf, int tid) {
  Jac p;
#pragma unroll
  for (int w = 0; w < BZ_NL; ++w) {
    p.x.v[w] = buf[w * BZ_WS_BLOCK + tid];
    p.y.v[w] = buf[(BZ_NL + w) * BZ_WS_BLOCK + tid];
    p.z.v[w] = buf[(2 * BZ_NL + w) * BZ_WS_BLOCK + tid];
  }
  return p;
}

// The body of a window kernel launched as window_grid(rows, log_threads)
// blocks of BZ_WS_BLOCK threads: buckets (rows, nbuck) points -> out (rows)
// points, each in the layout PLANAR selects. buf: the block's
// 3 * BZ_NL * BZ_WS_BLOCK words of shared memory.
template <bool PLANAR>
__device__ __forceinline__ void window_sums_body(const FieldConsts& F, const uint32_t* __restrict__ buckets,
                                                 uint32_t* __restrict__ out, long long rows, int nbuck,
                                                 int log_threads, int seg, uint32_t* buf) {
  const int tid = threadIdx.x;
  const int threads = 1 << log_threads;
  const int t = tid & (threads - 1);
  const long long row = (long long)blockIdx.x * (BZ_WS_BLOCK >> log_threads) + (tid >> log_threads);
  const int m = nbuck - 1;

  // 1. segment sums U_t (run) and A_t (acc)
  Jac run = jac_infinity(F);
  Jac acc = jac_infinity(F);
  if (row < rows) {
    for (int j = seg; j >= 1; --j) {
      const int b = t * seg + j;
      if (b <= m) run = jac_add(F, run, jac_load_at<PLANAR>(buckets, row * nbuck + b, rows * nbuck));
      acc = jac_add(F, acc, run);
    }
  }

  // 2. inclusive suffix scan of U_t over the row's threads
  for (int d = 1; d < threads; d <<= 1) {
    jac_to_shared(buf, tid, run);
    __syncthreads();
    if (t + d < threads) run = jac_add(F, run, jac_from_shared(buf, tid + d));
    __syncthreads();
  }

  // 3. z_t = s suffix_t + A_t, then the tree reduction of z over the row
  Jac z = t >= 1 ? run : jac_infinity(F);
  for (int k = 1; k < seg; k <<= 1) z = jac_double(F, z);
  z = jac_add(F, z, acc);
  for (int d = threads >> 1; d >= 1; d >>= 1) {
    jac_to_shared(buf, tid, z);
    __syncthreads();
    if (t < d) z = jac_add(F, z, jac_from_shared(buf, tid + d));
    __syncthreads();
  }
  if (row < rows && t == 0) jac_store_at<PLANAR>(out, row, rows, z);
}

// A row over 2^log_threads threads of a block, each with seg buckets (a
// power of two), covering its m = nbuck - 1 buckets.
static inline bool window_args_ok(int nbuck, int log_threads, int seg) {
  return nbuck >= 2 && log_threads >= 0 && (1 << log_threads) <= BZ_WS_BLOCK && seg >= 1 && !(seg & (seg - 1)) &&
         ((long long)seg << log_threads) >= nbuck - 1;
}

static inline unsigned int window_grid(long long rows, int log_threads) {
  const long long rows_per_block = BZ_WS_BLOCK >> log_threads;
  return (unsigned int)((rows + rows_per_block - 1) / rows_per_block);
}

// Threads of `kernel` the current card holds at once: its SMs times the
// blocks an SM keeps resident (from the kernel's registers and shared
// memory), times the block. ops/msm.py::window_layout splits rows so that
// all of them fit in this one wave.
template <typename Kernel>
static int window_resident_threads(Kernel kernel, long long* threads) {
  int device = 0, sms = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BZ_WS_BLOCK, 0);
  *threads = (long long)sms * blocks * BZ_WS_BLOCK;
  return (int)e;
}
