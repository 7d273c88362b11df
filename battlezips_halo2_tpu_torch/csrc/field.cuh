// Pasta field and curve arithmetic for Hopper, one element (or point) per
// thread.
//
// An element is 8 little-endian 32-bit limbs, value = sum v[i] * 2^(32 i),
// always canonical (< p). Multiplication is Montgomery with R = 2^256 by
// CIOS: 32 x 32 -> 64-bit products, which the compiler emits as
// mad.wide.u32 / mul.hi.u32, or, in a source that opts in
// (BZ_FE_CARRY_CHAIN), PTX carry chains. The TPU kernels this replaces split limbs into
// 16-bit halves and ran the products as bf16 matmuls because the TPU has no
// wide integer multiply; none of that carries over.
//
// The modulus arrives by value in FieldConsts (kernel parameters live in
// the constant bank), so every kernel serves both Fp and Fq.
//
// Points are Jacobian (X, Y, Z) with Z = 0 for the identity, as in the
// reference's curves/limb.py; the formulas and the order of their case
// selection are the same, so outputs are bit-identical to it, not only
// equal as group elements.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define BZ_NL 8

struct FieldConsts {
  uint32_t p[BZ_NL];
  uint32_t one[BZ_NL];  // R mod p, the Montgomery form of 1
  uint32_t n0;          // -p^-1 mod 2^32
};

// words: p[0..7], one[0..7], n0 (host memory, from the Python FieldSpec)
static inline FieldConsts field_consts(const uint32_t* words) {
  FieldConsts f;
  for (int i = 0; i < BZ_NL; ++i) {
    f.p[i] = words[i];
    f.one[i] = words[BZ_NL + i];
  }
  f.n0 = words[2 * BZ_NL];
  return f;
}

struct Fe {
  uint32_t v[BZ_NL];
};

struct Jac {
  Fe x, y, z;
};

// Rows are 32 bytes and the Python wrappers check 16-byte alignment, so an
// element moves as two 16-byte accesses.
__device__ __forceinline__ Fe fe_load(const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 a = s[0];
  uint4 b = s[1];
  Fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* dst, const Fe& x) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(x.v[0], x.v[1], x.v[2], x.v[3]);
  d[1] = make_uint4(x.v[4], x.v[5], x.v[6], x.v[7]);
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) r.v[i] = 0u;
  return r;
}

__device__ __forceinline__ Fe fe_one(const FieldConsts& F) {
  Fe r;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) r.v[i] = F.one[i];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) acc |= a.v[i];
  return acc == 0u;
}

// A source that defines BZ_FE_MUL_CALL before including this header calls
// one out-of-line copy of the product instead of inlining it. A point
// addition inlines 11-24 products of ~400 instructions each; on the H100
// the call cut the time of long addition chains by a third to a half, and
// slowed the quotient VM by half (PERF.md §6).
#ifdef BZ_FE_MUL_CALL
#define BZ_FE_MUL_DECL static __device__ __noinline__
#else
#define BZ_FE_MUL_DECL __device__ __forceinline__
#endif

// A source that defines BZ_FE_CARRY_CHAIN before including this header gets
// the field ops below written as PTX carry chains; the others get these,
// 64-bit C++ whose carries travel in the top half of each sum.
#ifndef BZ_FE_CARRY_CHAIN

// t (9 words, value < 2p) -> t mod p
__device__ __forceinline__ Fe fe_reduce_once(const FieldConsts& F, const uint32_t* t) {
  Fe d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) {
    uint64_t s = (uint64_t)t[i] - F.p[i] - borrow;
    d.v[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = t[BZ_NL] >= borrow;  // no borrow out of the top word: t >= p
  Fe r;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) r.v[i] = ge ? d.v[i] : t[i];
  return r;
}

__device__ __forceinline__ Fe fe_add(const FieldConsts& F, const Fe& a, const Fe& b) {
  uint32_t t[BZ_NL + 1];
  uint32_t carry = 0u;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) {
    uint64_t s = (uint64_t)a.v[i] + b.v[i] + carry;
    t[i] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  t[BZ_NL] = carry;
  return fe_reduce_once(F, t);
}

__device__ __forceinline__ Fe fe_sub(const FieldConsts& F, const Fe& a, const Fe& b) {
  Fe d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) {
    uint64_t s = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const uint32_t mask = 0u - borrow;  // a < b: add p back
  uint32_t carry = 0u;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) {
    uint64_t s = (uint64_t)d.v[i] + (F.p[i] & mask) + carry;
    d.v[i] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  return d;
}

// Montgomery product a * b * 2^-256 mod p (CIOS), a, b < p.
BZ_FE_MUL_DECL Fe fe_mul(const FieldConsts& F, const Fe& a, const Fe& b) {
  uint32_t t[BZ_NL + 2];
#pragma unroll
  for (int i = 0; i < BZ_NL + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < BZ_NL; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[BZ_NL] + c;
    t[BZ_NL] = (uint32_t)s;
    t[BZ_NL + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F.n0;
    s = (uint64_t)m * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < BZ_NL; ++j) {
      s = (uint64_t)m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[BZ_NL] + c;
    t[BZ_NL - 1] = (uint32_t)s;
    t[BZ_NL] = t[BZ_NL + 1] + (uint32_t)(s >> 32);
  }
  return fe_reduce_once(F, t);
}

// x R^-1 mod p for canonical x: the reduction half of fe_mul's CIOS loop
// on x with a zero high half; the value stays below 2p throughout.
__device__ __forceinline__ Fe fe_redc(const FieldConsts& F, const Fe& x) {
  uint32_t t[BZ_NL + 1];
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) t[i] = x.v[i];
  t[BZ_NL] = 0u;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) {
    const uint32_t m = t[0] * F.n0;
    uint64_t s = (uint64_t)m * F.p[0] + t[0];
    uint64_t c = s >> 32;
#pragma unroll
    for (int j = 1; j < BZ_NL; ++j) {
      s = (uint64_t)m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[BZ_NL] + c;
    t[BZ_NL - 1] = (uint32_t)s;
    t[BZ_NL] = (uint32_t)(s >> 32);
  }
  return fe_reduce_once(F, t);
}

#else  // BZ_FE_CARRY_CHAIN

// ------------------------------------------------- carry-chain field ops
//
// The carry rides in the condition code: add.cc / addc, sub.cc / subc and
// mad.lo.cc / madc.hi.cc, one PTX instruction per helper below. A chain is
// a run of these statements with nothing between them that writes the
// flag (the compiler's own code never does), kept in order by volatile.
// The product is CIOS with a's limbs split into an even accumulator (a[0],
// a[2], ... times b[i]: words j and j + 1 for even j do not overlap) and an
// odd one (a[1], a[3], ..., one word up), so each step is two carry chains
// that do not wait on each other; m * p splits the same way. After each
// word of b the sum shifts down a word and the two accumulators swap
// roles. Both Pasta primes are below 2^255, so every sum fits and the
// carries out of the top words are zero. Outputs are canonical: the same
// bits as the 64-bit versions.

__device__ __forceinline__ uint32_t cc_add(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_end(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_sub(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_end(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo(a * b) + c, carry out
__device__ __forceinline__ uint32_t cc_mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_madc_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_end(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// acc[j], acc[j + 1] = a[j] * bi for even j: no carries
__device__ __forceinline__ void cc_mul_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < BZ_NL; j += 2) {
    acc[j] = a[j] * bi;
    acc[j + 1] = __umulhi(a[j], bi);
  }
}

// acc += a[j] * bi at words j, j + 1 for even j; the carry out of acc[7]
// stays in the flag
__device__ __forceinline__ void cc_cmad_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
  acc[0] = cc_mad_lo(a[0], bi, acc[0]);
  acc[1] = cc_madc_hi(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < BZ_NL; j += 2) {
    acc[j] = cc_madc_lo(a[j], bi, acc[j]);
    acc[j + 1] = cc_madc_hi(a[j], bi, acc[j + 1]);
  }
}

// odd[j] = odd[j + 2] + a[j] * bi + carry: the odd accumulator moves down
// the two words by which it trails after a swap
__device__ __forceinline__ void cc_madc_n_rshift(uint32_t* odd, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < BZ_NL - 2; j += 2) {
    odd[j] = cc_madc_lo(a[j], bi, odd[j + 2]);
    odd[j + 1] = cc_madc_hi(a[j], bi, odd[j + 3]);
  }
  odd[BZ_NL - 2] = cc_madc_lo(a[BZ_NL - 2], bi, 0u);
  odd[BZ_NL - 1] = madc_hi_end(a[BZ_NL - 2], bi, 0u);
}

// One word of b: (even + odd * 2^32) += a * bi, then + m * p with
// m = even[0] * n0, which zeroes word 0. On entry after the first word
// even holds words 0..7 and odd, the previous even, words -1..6.
__device__ __forceinline__ void cc_mad_n_redc(const FieldConsts& F, uint32_t* even, uint32_t* odd,
                                              const uint32_t* a, uint32_t bi, bool first) {
  if (first) {
    cc_mul_n(odd, a + 1, bi);
    cc_mul_n(even, a, bi);
  } else {
    even[0] = cc_add(even[0], odd[1]);
    cc_madc_n_rshift(odd, a + 1, bi);
    cc_cmad_n(even, a, bi);
    odd[BZ_NL - 1] = addc_end(odd[BZ_NL - 1], 0u);
  }
  const uint32_t m = even[0] * F.n0;
  cc_cmad_n(odd, F.p + 1, m);
  cc_cmad_n(even, F.p, m);
  odd[BZ_NL - 1] = addc_end(odd[BZ_NL - 1], 0u);
}

// t (9 words, value < 2p) -> t mod p
__device__ __forceinline__ Fe fe_reduce_once(const FieldConsts& F, const uint32_t* t) {
  uint32_t d[BZ_NL];
  d[0] = cc_sub(t[0], F.p[0]);
#pragma unroll
  for (int i = 1; i < BZ_NL; ++i) d[i] = cc_subc(t[i], F.p[i]);
  cc_subc(t[BZ_NL], 0u);
  const uint32_t lt = subc_end(0u, 0u);  // a borrow out of the top word: t < p
  Fe r;
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) r.v[i] = lt ? t[i] : d[i];
  return r;
}

__device__ __forceinline__ Fe fe_add(const FieldConsts& F, const Fe& a, const Fe& b) {
  uint32_t t[BZ_NL + 1];
  t[0] = cc_add(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < BZ_NL; ++i) t[i] = cc_addc(a.v[i], b.v[i]);
  t[BZ_NL] = addc_end(0u, 0u);
  return fe_reduce_once(F, t);
}

__device__ __forceinline__ Fe fe_sub(const FieldConsts& F, const Fe& a, const Fe& b) {
  Fe d;
  d.v[0] = cc_sub(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < BZ_NL; ++i) d.v[i] = cc_subc(a.v[i], b.v[i]);
  const uint32_t mask = subc_end(0u, 0u);  // a < b: add p back
  uint32_t pm[BZ_NL];
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) pm[i] = F.p[i] & mask;
  d.v[0] = cc_add(d.v[0], pm[0]);
#pragma unroll
  for (int i = 1; i < BZ_NL - 1; ++i) d.v[i] = cc_addc(d.v[i], pm[i]);
  d.v[BZ_NL - 1] = addc_end(d.v[BZ_NL - 1], pm[BZ_NL - 1]);
  return d;
}

// t (9 words) = even + odd[1..7]: the value after the last word of b,
// shifted down a word (odd, the last round's even, holds words -1..6)
__device__ __forceinline__ void cc_fold(uint32_t* t, const uint32_t* even, const uint32_t* odd) {
  t[0] = cc_add(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < BZ_NL - 1; ++j) t[j] = cc_addc(even[j], odd[j + 1]);
  t[BZ_NL - 1] = cc_addc(even[BZ_NL - 1], 0u);
  t[BZ_NL] = addc_end(0u, 0u);
}

// Montgomery product a * b * 2^-256 mod p, a, b < p.
BZ_FE_MUL_DECL Fe fe_mul(const FieldConsts& F, const Fe& a, const Fe& b) {
  uint32_t even[BZ_NL], odd[BZ_NL];
#pragma unroll
  for (int i = 0; i < BZ_NL; i += 2) {
    cc_mad_n_redc(F, even, odd, a.v, b.v[i], i == 0);
    cc_mad_n_redc(F, odd, even, a.v, b.v[i + 1], false);
  }
  uint32_t t[BZ_NL + 1];
  cc_fold(t, even, odd);
  return fe_reduce_once(F, t);
}

// x R^-1 mod p for canonical x: fe_mul's reduction alone (b = 1), with the
// sum x + m * p starting in the even accumulator. The result is below p
// ((x + M p) / 2^256 with x < p and M < 2^256), so nothing is subtracted.
__device__ __forceinline__ Fe fe_redc(const FieldConsts& F, const Fe& x) {
  uint32_t even[BZ_NL], odd[BZ_NL];
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) {
    even[i] = x.v[i];
    odd[i] = 0u;
  }
#pragma unroll
  for (int i = 0; i < BZ_NL; ++i) {
    uint32_t* e = (i & 1) ? odd : even;
    uint32_t* o = (i & 1) ? even : odd;
    if (i > 0) {  // shift down a word: o's words -1..6 become 0..5 of its next role
      e[0] = cc_add(e[0], o[1]);
#pragma unroll
      for (int j = 0; j < BZ_NL - 2; ++j) o[j] = cc_addc(o[j + 2], 0u);
      o[BZ_NL - 2] = addc_end(0u, 0u);
      o[BZ_NL - 1] = 0u;
    }
    const uint32_t m = e[0] * F.n0;
    cc_cmad_n(o, F.p + 1, m);
    cc_cmad_n(e, F.p, m);
    o[BZ_NL - 1] = addc_end(o[BZ_NL - 1], 0u);
  }
  uint32_t t[BZ_NL + 1];
  cc_fold(t, even, odd);
  Fe r;
#pragma unroll
  for (int j = 0; j < BZ_NL; ++j) r.v[j] = t[j];
  return r;
}

#endif  // BZ_FE_CARRY_CHAIN

// ------------------------------------------------------------------ points

__device__ __forceinline__ Jac jac_load(const uint32_t* src) {
  Jac r;
  r.x = fe_load(src);
  r.y = fe_load(src + BZ_NL);
  r.z = fe_load(src + 2 * BZ_NL);
  return r;
}

__device__ __forceinline__ void jac_store(uint32_t* dst, const Jac& p) {
  fe_store(dst, p.x);
  fe_store(dst + BZ_NL, p.y);
  fe_store(dst + 2 * BZ_NL, p.z);
}

// Point i of a batch of n: interleaved (n, 3, 8), a point every 24 words
// and a coordinate every 8; or, PLANAR, planes (3, n, 8), a coordinate
// every 8 n words.
template <bool PLANAR>
__device__ __forceinline__ Jac jac_load_at(const uint32_t* src, long long i, long long n) {
  if (!PLANAR) return jac_load(src + i * 3 * BZ_NL);
  Jac r;
  r.x = fe_load(src + i * BZ_NL);
  r.y = fe_load(src + (n + i) * BZ_NL);
  r.z = fe_load(src + (2 * n + i) * BZ_NL);
  return r;
}

template <bool PLANAR>
__device__ __forceinline__ void jac_store_at(uint32_t* dst, long long i, long long n, const Jac& p) {
  if (!PLANAR) {
    jac_store(dst + i * 3 * BZ_NL, p);
    return;
  }
  fe_store(dst + i * BZ_NL, p.x);
  fe_store(dst + (n + i) * BZ_NL, p.y);
  fe_store(dst + (2 * n + i) * BZ_NL, p.z);
}

__device__ __forceinline__ Jac jac_infinity(const FieldConsts& F) {
  Jac r;
  r.x = fe_one(F);
  r.y = fe_one(F);
  r.z = fe_zero();
  return r;
}

// affine (x, y) -> Jacobian, the all-zero row being the identity
__device__ __forceinline__ Jac jac_lift(const FieldConsts& F, const Fe& x, const Fe& y, bool inf) {
  Jac r;
  r.x = x;
  r.y = y;
  r.z = inf ? fe_zero() : fe_one(F);
  return r;
}

// 2P on y^2 = x^3 + b ('dbl-2009-l'); Z = 0 stays the identity.
__device__ __forceinline__ Jac jac_double(const FieldConsts& F, const Jac& p) {
  const Fe A = fe_mul(F, p.x, p.x);
  const Fe B = fe_mul(F, p.y, p.y);
  const Fe C = fe_mul(F, B, B);
  const Fe xb = fe_add(F, p.x, B);
  const Fe t = fe_sub(F, fe_sub(F, fe_mul(F, xb, xb), A), C);
  const Fe D = fe_add(F, t, t);
  const Fe E = fe_add(F, fe_add(F, A, A), A);
  const Fe Fs = fe_mul(F, E, E);
  Jac r;
  r.x = fe_sub(F, Fs, fe_add(F, D, D));
  Fe c8 = fe_add(F, C, C);
  c8 = fe_add(F, c8, c8);
  c8 = fe_add(F, c8, c8);
  r.y = fe_sub(F, fe_mul(F, E, fe_sub(F, D, r.x)), c8);
  const Fe yz = fe_mul(F, p.y, p.z);
  r.z = fe_add(F, yz, yz);
  return r;
}

// Complete P + Q ('add-2007-bl' with the identity, P == Q and P == -Q cases
// selected in the reference's order: p_inf > q_inf > h == 0 > generic).
__device__ __forceinline__ Jac jac_add(const FieldConsts& F, const Jac& p, const Jac& q) {
  if (fe_is_zero(p.z)) return q;
  if (fe_is_zero(q.z)) return p;
  const Fe z1z1 = fe_mul(F, p.z, p.z);
  const Fe z2z2 = fe_mul(F, q.z, q.z);
  const Fe u1 = fe_mul(F, p.x, z2z2);
  const Fe u2 = fe_mul(F, q.x, z1z1);
  const Fe s1 = fe_mul(F, fe_mul(F, p.y, q.z), z2z2);
  const Fe s2 = fe_mul(F, fe_mul(F, q.y, p.z), z1z1);
  const Fe h = fe_sub(F, u2, u1);
  const Fe r = fe_sub(F, s2, s1);
  if (fe_is_zero(h)) return fe_is_zero(r) ? jac_double(F, p) : jac_infinity(F);
  const Fe hh = fe_mul(F, h, h);
  const Fe hhh = fe_mul(F, h, hh);
  const Fe v = fe_mul(F, u1, hh);
  Jac o;
  o.x = fe_sub(F, fe_sub(F, fe_mul(F, r, r), hhh), fe_add(F, v, v));
  o.y = fe_sub(F, fe_mul(F, r, fe_sub(F, v, o.x)), fe_mul(F, s1, hhh));
  o.z = fe_mul(F, fe_mul(F, p.z, q.z), h);
  return o;
}

// P + Q with Q affine ('madd-2007-bl'). COMPLETE selects the doubling case;
// otherwise P == Q (h == 0, r == 0) leaves the generic formula's output and
// raises needs_double, as the reference's point_add_mixed_incomplete does.
template <bool COMPLETE>
__device__ __forceinline__ Jac jac_add_mixed(const FieldConsts& F, const Jac& p, const Fe& qx,
                                             const Fe& qy, bool q_inf, bool& needs_double) {
  needs_double = false;
  if (fe_is_zero(p.z)) return jac_lift(F, qx, qy, q_inf);
  if (q_inf) return p;
  const Fe z1z1 = fe_mul(F, p.z, p.z);
  const Fe u2 = fe_mul(F, qx, z1z1);
  const Fe s2 = fe_mul(F, fe_mul(F, qy, p.z), z1z1);
  const Fe h = fe_sub(F, u2, p.x);
  const Fe r = fe_sub(F, s2, p.y);
  const bool h_zero = fe_is_zero(h);
  const bool r_zero = fe_is_zero(r);
  if (h_zero && !r_zero) return jac_infinity(F);
  if (h_zero && COMPLETE) return jac_double(F, p);
  needs_double = h_zero;
  const Fe hh = fe_mul(F, h, h);
  const Fe hhh = fe_mul(F, h, hh);
  const Fe v = fe_mul(F, p.x, hh);
  Jac o;
  o.x = fe_sub(F, fe_sub(F, fe_mul(F, r, r), hhh), fe_add(F, v, v));
  o.y = fe_sub(F, fe_mul(F, r, fe_sub(F, v, o.x)), fe_mul(F, p.y, hhh));
  o.z = fe_mul(F, p.z, h);
  return o;
}

static inline unsigned int grid_for(long long n, unsigned int block) {
  return (unsigned int)((n + block - 1) / block);
}
