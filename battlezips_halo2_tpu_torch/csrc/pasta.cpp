// Native host-side Pasta arithmetic: 4x64-bit Montgomery fields, Jacobian
// curve ops, Pippenger MSM and batch inversion.
//
// The host engine of battlezips_halo2_tpu_torch: the card runs the CUDA
// kernels of this directory; this library runs the proof's work on the host
// when BZ_PROOF_ENGINE (auto / host) or BZ_BATCH_ENGINE=host selects it:
// batch NTT, the quotient bytecode VM, Pippenger commits, the multiopen and
// IPA folds, batch inversions. Built with g++ at first use and bound with
// ctypes (battlezips_halo2_tpu_torch/native/__init__.py); it is not part of
// the nvcc build.
//
// Element encoding at the ABI: 32-byte little-endian canonical reprs
// (matching ff::PrimeField::to_repr and fields/host.py). Points: 64 bytes
// (x||y), identity = all-zero.

#include <cstdint>
#include <cstring>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

struct Fe {
    u64 l[4];
};

struct FieldCtx {
    Fe modulus;
    Fe r2;      // R^2 mod p (computed at init)
    Fe one;     // R mod p   (computed at init)
    u64 inv;    // -p^{-1} mod 2^64 (computed at init)
    bool ready = false;
};

// Pallas base field p (= Vesta scalar field); only the modulus is baked in.
static FieldCtx FP_CTX = {
    {{0x992d30ed00000001ULL, 0x224698fc094cf91bULL, 0x0000000000000000ULL, 0x4000000000000000ULL}},
    {}, {}, 0, false,
};
// Vesta base field q (= Pallas scalar field)
static FieldCtx FQ_CTX = {
    {{0x8c46eb2100000001ULL, 0x224698fc0994a8ddULL, 0x0000000000000000ULL, 0x4000000000000000ULL}},
    {}, {}, 0, false,
};

static bool fe_gte(const Fe& a, const Fe& b);
static void fe_sub_raw(Fe& out, const Fe& a, const Fe& b);

static void ctx_init(FieldCtx* c) {
    if (c->ready) return;
    // inv = -p^{-1} mod 2^64 via Newton iteration
    u64 p0 = c->modulus.l[0];
    u64 x = 1;
    for (int i = 0; i < 6; ++i) x *= 2 - p0 * x;  // x = p0^{-1} mod 2^64
    c->inv = (u64)(0 - x);
    // one = R = 2^256 mod p by 256 modular doublings of 1
    Fe r = {{1, 0, 0, 0}};
    for (int i = 0; i < 256; ++i) {
        u128 carry = 0;
        Fe t;
        for (int j = 0; j < 4; ++j) {
            u128 s = ((u128)r.l[j] << 1) | carry;
            t.l[j] = (u64)s;
            carry = s >> 64;
        }
        if (carry || fe_gte(t, c->modulus)) fe_sub_raw(t, t, c->modulus);
        r = t;
    }
    c->one = r;
    // r2 = R^2 mod p = R doubled 256 more times
    Fe r2 = r;
    for (int i = 0; i < 256; ++i) {
        u128 carry = 0;
        Fe t;
        for (int j = 0; j < 4; ++j) {
            u128 s = ((u128)r2.l[j] << 1) | carry;
            t.l[j] = (u64)s;
            carry = s >> 64;
        }
        if (carry || fe_gte(t, c->modulus)) fe_sub_raw(t, t, c->modulus);
        r2 = t;
    }
    c->r2 = r2;
    c->ready = true;
}

static inline const FieldCtx* ctx_for(int which) {
    FieldCtx* c = which == 0 ? &FP_CTX : &FQ_CTX;
    ctx_init(c);
    return c;
}

static inline bool fe_is_zero(const Fe& a) {
    return (a.l[0] | a.l[1] | a.l[2] | a.l[3]) == 0;
}

static inline bool fe_gte(const Fe& a, const Fe& b) {
    for (int i = 3; i >= 0; --i) {
        if (a.l[i] > b.l[i]) return true;
        if (a.l[i] < b.l[i]) return false;
    }
    return true;
}

static inline void fe_sub_raw(Fe& out, const Fe& a, const Fe& b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.l[i] - b.l[i] - borrow;
        out.l[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void fe_add(const FieldCtx* c, Fe& out, const Fe& a, const Fe& b) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a.l[i] + b.l[i] + carry;
        out.l[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || fe_gte(out, c->modulus)) fe_sub_raw(out, out, c->modulus);
}

static inline void fe_sub(const FieldCtx* c, Fe& out, const Fe& a, const Fe& b) {
    Fe t;
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.l[i] - b.l[i] - borrow;
        t.l[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            u128 s = (u128)t.l[i] + c->modulus.l[i] + carry;
            t.l[i] = (u64)s;
            carry = s >> 64;
        }
    }
    out = t;
}

// CIOS Montgomery multiplication
static void fe_mul(const FieldCtx* c, Fe& out, const Fe& a, const Fe& b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[4] + carry;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);

        u64 m = t[0] * c->inv;
        carry = ((u128)t[0] + (u128)m * c->modulus.l[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 s2 = (u128)t[j] + (u128)m * c->modulus.l[j] + carry;
            t[j - 1] = (u64)s2;
            carry = s2 >> 64;
        }
        s = (u128)t[4] + carry;
        t[3] = (u64)s;
        t[4] = t[5] + (u64)(s >> 64);
    }
    Fe r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || fe_gte(r, c->modulus)) fe_sub_raw(r, r, c->modulus);
    out = r;
}

static void fe_sqr(const FieldCtx* c, Fe& out, const Fe& a) { fe_mul(c, out, a, a); }

static void fe_pow(const FieldCtx* c, Fe& out, const Fe& base, const Fe& exp_plain) {
    Fe result = c->one;
    Fe b = base;
    for (int limb = 3; limb >= 0; --limb) {
        for (int bit = 63; bit >= 0; --bit) {
            fe_sqr(c, result, result);
            if ((exp_plain.l[limb] >> bit) & 1) fe_mul(c, result, result, b);
        }
    }
    out = result;
}

static void fe_inv(const FieldCtx* c, Fe& out, const Fe& a) {
    // a^(p-2) in Montgomery form
    Fe e = c->modulus;
    u128 borrow = 2;
    for (int i = 0; i < 4 && borrow; ++i) {
        u128 d = (u128)e.l[i] - borrow;
        e.l[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    fe_pow(c, out, a, e);
}

static void fe_to_mont(const FieldCtx* c, Fe& out, const Fe& a) { fe_mul(c, out, a, c->r2); }

// Legendre symbol via Euler's criterion on a Montgomery-form input:
// 1 = nonzero quadratic residue, 0 = zero, -1 = non-residue.
static int fe_legendre(const FieldCtx* c, const Fe& a_mont) {
    if (fe_is_zero(a_mont)) return 0;
    Fe e = c->modulus;  // (p-1)/2: p odd so no borrow from the -1
    e.l[0] -= 1;
    for (int i = 0; i < 3; ++i) e.l[i] = (e.l[i] >> 1) | (e.l[i + 1] << 63);
    e.l[3] >>= 1;
    Fe r;
    fe_pow(c, r, a_mont, e);
    return std::memcmp(&r, &c->one, 32) == 0 ? 1 : -1;
}

static void fe_from_mont(const FieldCtx* c, Fe& out, const Fe& a) {
    Fe one_plain = {{1, 0, 0, 0}};
    fe_mul(c, out, a, one_plain);
}

// ---------------------------------------------------------------- EC layer
// Jacobian over the given base field, curve y^2 = x^3 + 5.
struct Pt {
    Fe x, y, z;  // Montgomery form; z == 0 -> identity
};

static void pt_identity(Pt& p) { std::memset(&p, 0, sizeof(Pt)); }

static void pt_double(const FieldCtx* c, Pt& out, const Pt& p) {
    if (fe_is_zero(p.z)) { out = p; return; }
    Fe A, B, C, D, E, F, t, X3, Y3, Z3;
    fe_sqr(c, A, p.x);
    fe_sqr(c, B, p.y);
    fe_sqr(c, C, B);
    fe_add(c, t, p.x, B);
    fe_sqr(c, t, t);
    fe_sub(c, t, t, A);
    fe_sub(c, t, t, C);
    fe_add(c, D, t, t);
    fe_add(c, E, A, A);
    fe_add(c, E, E, A);
    fe_sqr(c, F, E);
    fe_add(c, t, D, D);
    fe_sub(c, X3, F, t);
    Fe c8;
    fe_add(c, c8, C, C);
    fe_add(c, c8, c8, c8);
    fe_add(c, c8, c8, c8);
    fe_sub(c, t, D, X3);
    fe_mul(c, Y3, E, t);
    fe_sub(c, Y3, Y3, c8);
    fe_mul(c, Z3, p.y, p.z);
    fe_add(c, Z3, Z3, Z3);
    out.x = X3; out.y = Y3; out.z = Z3;
}

static void pt_add(const FieldCtx* c, Pt& out, const Pt& p, const Pt& q) {
    if (fe_is_zero(p.z)) { out = q; return; }
    if (fe_is_zero(q.z)) { out = p; return; }
    Fe z1z1, z2z2, u1, u2, s1, s2, h, r, hh, hhh, v, t;
    fe_sqr(c, z1z1, p.z);
    fe_sqr(c, z2z2, q.z);
    fe_mul(c, u1, p.x, z2z2);
    fe_mul(c, u2, q.x, z1z1);
    fe_mul(c, s1, p.y, q.z);
    fe_mul(c, s1, s1, z2z2);
    fe_mul(c, s2, q.y, p.z);
    fe_mul(c, s2, s2, z1z1);
    fe_sub(c, h, u2, u1);
    fe_sub(c, r, s2, s1);
    if (fe_is_zero(h)) {
        if (fe_is_zero(r)) { pt_double(c, out, p); return; }
        pt_identity(out);
        return;
    }
    fe_sqr(c, hh, h);
    fe_mul(c, hhh, hh, h);
    fe_mul(c, v, u1, hh);
    Fe r2v;
    fe_sqr(c, r2v, r);
    fe_sub(c, r2v, r2v, hhh);
    fe_add(c, t, v, v);
    fe_sub(c, out.x, r2v, t);
    fe_sub(c, t, v, out.x);
    fe_mul(c, t, r, t);
    Fe s1hhh;
    fe_mul(c, s1hhh, s1, hhh);
    fe_sub(c, out.y, t, s1hhh);
    fe_mul(c, out.z, p.z, q.z);
    fe_mul(c, out.z, out.z, h);
}

// Mixed addition: q is an affine Montgomery point (z = 1, not identity).
// ~8 muls vs pt_add's ~16 — the bucket-accumulation workhorse. All
// intermediates are locals, so out may alias p.
static void pt_add_mixed(const FieldCtx* c, Pt& out, const Pt& p, const Fe& qx, const Fe& qy) {
    if (fe_is_zero(p.z)) {
        out.x = qx;
        out.y = qy;
        out.z = c->one;
        return;
    }
    Fe z1z1, u2, s2, h, r;
    fe_sqr(c, z1z1, p.z);
    fe_mul(c, u2, qx, z1z1);
    fe_mul(c, s2, qy, p.z);
    fe_mul(c, s2, s2, z1z1);
    fe_sub(c, h, u2, p.x);
    fe_sub(c, r, s2, p.y);
    if (fe_is_zero(h)) {
        if (fe_is_zero(r)) {
            pt_double(c, out, p);
            return;
        }
        pt_identity(out);
        return;
    }
    Fe hh, hhh, v, t, r2;
    fe_sqr(c, hh, h);
    fe_mul(c, hhh, hh, h);
    fe_mul(c, v, p.x, hh);
    fe_sqr(c, r2, r);
    fe_sub(c, r2, r2, hhh);
    fe_add(c, t, v, v);
    Fe ox, oy, oz;
    fe_sub(c, ox, r2, t);
    fe_sub(c, t, v, ox);
    fe_mul(c, t, r, t);
    Fe s1hhh;
    fe_mul(c, s1hhh, p.y, hhh);
    fe_sub(c, oy, t, s1hhh);
    fe_mul(c, oz, p.z, h);
    out.x = ox;
    out.y = oy;
    out.z = oz;
}

static void pt_to_affine(const FieldCtx* c, Fe& ax, Fe& ay, const Pt& p) {
    if (fe_is_zero(p.z)) { std::memset(&ax, 0, sizeof(Fe)); std::memset(&ay, 0, sizeof(Fe)); return; }
    Fe zi, zi2, zi3;
    fe_inv(c, zi, p.z);
    fe_sqr(c, zi2, zi);
    fe_mul(c, zi3, zi2, zi);
    fe_mul(c, ax, p.x, zi2);
    fe_mul(c, ay, p.y, zi3);
}

// ---------------------------------------------------------------- C ABI
// Tonelli-Shanks square root (both Pasta fields: 2-adicity 32, generator 5).
// a_mont in Montgomery form; returns false for a non-residue. The root is
// not sign-normalized (matches fields/host.py sqrt — callers pick parity).
static bool fe_sqrt(const FieldCtx* c, Fe& out, const Fe& a_mont) {
    if (fe_is_zero(a_mont)) {
        out = a_mont;
        return true;
    }
    if (fe_legendre(c, a_mont) != 1) return false;
    // t = (m - 1) >> 32  (s = 32); low 32 bits of m-1 are zero for Pasta
    Fe t = c->modulus;
    t.l[0] -= 1;
    for (int i = 0; i < 3; ++i) t.l[i] = (t.l[i] >> 32) | (t.l[i + 1] << 32);
    t.l[3] >>= 32;
    // z = g^t with g = 5 (pasta_curves Fp/Fq GENERATOR)
    Fe g = {{5, 0, 0, 0}};
    fe_to_mont(c, g, g);
    Fe z;
    fe_pow(c, z, g, t);
    // x = a^((t+1)/2); t is odd so (t+1)/2 = (t>>1)+1
    Fe e = t;
    for (int i = 0; i < 3; ++i) e.l[i] = (e.l[i] >> 1) | (e.l[i + 1] << 63);
    e.l[3] >>= 1;
    u128 carry = 1;
    for (int i = 0; i < 4 && carry; ++i) {
        u128 s = (u128)e.l[i] + carry;
        e.l[i] = (u64)s;
        carry = s >> 64;
    }
    Fe x, b;
    fe_pow(c, x, a_mont, e);
    fe_pow(c, b, a_mont, t);
    int s = 32;
    while (std::memcmp(&b, &c->one, 32) != 0) {
        int k = 0;
        Fe b2 = b;
        while (std::memcmp(&b2, &c->one, 32) != 0) {
            fe_sqr(c, b2, b2);
            ++k;
        }
        Fe w = z;
        for (int i = 0; i < s - k - 1; ++i) fe_sqr(c, w, w);
        fe_sqr(c, z, w);
        fe_mul(c, b, b, z);
        fe_mul(c, x, x, w);
        s = k;
    }
    out = x;
    return true;
}

extern "C" {

// Batch compressed-point decode (pasta_curves GroupEncoding / transcript
// read_point): in = n*32-byte compressed reprs (x with (y&1)<<7 in byte
// 31), out = n*64-byte affine (x||y) canonical, status[i] = 0 ok,
// 1 identity, 2 malformed (non-canonical x or x not on curve). Returns
// the index of the first malformed encoding, or -1.
int64_t pasta_point_decompress(int which, const uint8_t* in, uint8_t* out,
                               uint8_t* status, int64_t n) {
    const FieldCtx* c = ctx_for(which);
    int64_t bad = -1;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t buf[32];
        std::memcpy(buf, in + 32 * i, 32);
        int ysign = buf[31] >> 7;
        buf[31] &= 0x7f;
        Fe x;
        std::memcpy(&x, buf, 32);
        std::memset(out + 64 * i, 0, 64);
        if (fe_gte(x, c->modulus)) {  // non-canonical repr
            status[i] = 2;
            if (bad < 0) bad = i;
            continue;
        }
        if (fe_is_zero(x) && ysign == 0) {
            status[i] = 1;  // identity encoding
            continue;
        }
        Fe xm, y2, ym;
        fe_to_mont(c, xm, x);
        fe_sqr(c, y2, xm);
        fe_mul(c, y2, y2, xm);
        Fe b5 = {{5, 0, 0, 0}};
        fe_to_mont(c, b5, b5);
        fe_add(c, y2, y2, b5);
        if (!fe_sqrt(c, ym, y2)) {
            status[i] = 2;
            if (bad < 0) bad = i;
            continue;
        }
        Fe y;
        fe_from_mont(c, y, ym);
        if ((int)(y.l[0] & 1) != ysign) fe_sub_raw(y, c->modulus, y);
        status[i] = 0;
        std::memcpy(out + 64 * i, &x, 32);
        std::memcpy(out + 64 * i + 32, &y, 32);
    }
    return bad;
}

// IPA verifier s-vector: s_i = a0 * prod_{j : bit (k-1-j) of i} u_j,
// built by k doubling passes (n-1 muls total). us: k*32 bytes plain,
// a0: 32 bytes plain, out: n*32 bytes plain canonical. n = 2^k.
void pasta_ipa_s(int which, const uint8_t* us, const uint8_t* a0_bytes,
                 uint8_t* out, int64_t n, int64_t k) {
    const FieldCtx* c = ctx_for(which);
    std::vector<Fe> s((size_t)n);
    Fe a0;
    std::memcpy(&a0, a0_bytes, 32);
    fe_to_mont(c, s[0], a0);
    int64_t len = 1;
    for (int64_t j = k - 1; j >= 0; --j) {
        Fe u;
        std::memcpy(&u, us + 32 * j, 32);
        fe_to_mont(c, u, u);
        for (int64_t i = 0; i < len; ++i) fe_mul(c, s[len + i], s[i], u);
        len <<= 1;
    }
    for (int64_t i = 0; i < n; ++i) {
        Fe r;
        fe_from_mont(c, r, s[i]);
        std::memcpy(out + 32 * i, &r, 32);
    }
}

// Grand-product prefix (permutation / lookup z build): given nums and dens
// (usable*32 plain) and the chaining carry, computes
//   z[0] = carry;  z[i+1] = z[i] * nums[i] / dens[i]
// with ONE field inversion (Montgomery batch inversion of the dens).
// out: (usable+1)*32 plain canonical.
void pasta_grand_product(int which, const uint8_t* nums, const uint8_t* dens,
                         const uint8_t* carry_bytes, uint8_t* out, int64_t usable) {
    const FieldCtx* c = ctx_for(which);
    std::vector<Fe> dv((size_t)usable), prefix((size_t)usable);
    Fe acc = c->one;
    for (int64_t i = 0; i < usable; ++i) {
        std::memcpy(&dv[i], dens + 32 * i, 32);
        fe_to_mont(c, dv[i], dv[i]);
        prefix[i] = acc;
        fe_mul(c, acc, acc, dv[i]);
    }
    Fe inv;
    fe_inv(c, inv, acc);
    std::vector<Fe> dinv((size_t)usable);
    for (int64_t i = usable - 1; i >= 0; --i) {
        fe_mul(c, dinv[i], prefix[i], inv);
        fe_mul(c, inv, inv, dv[i]);
    }
    Fe z;
    std::memcpy(&z, carry_bytes, 32);
    std::memcpy(out, carry_bytes, 32);
    fe_to_mont(c, z, z);
    for (int64_t i = 0; i < usable; ++i) {
        Fe num;
        std::memcpy(&num, nums + 32 * i, 32);
        fe_to_mont(c, num, num);
        fe_mul(c, z, z, num);
        fe_mul(c, z, z, dinv[i]);  // dinv still in Montgomery domain
        Fe r;
        fe_from_mont(c, r, z);
        std::memcpy(out + 32 * (i + 1), &r, 32);
    }
}

// Horner window fold of Pippenger window sums: out = sum_w 2^(c*w) * W_w,
// folded MSB-first with c doublings per window. wsums: n_windows * 64-byte
// affine points (identity = zeros) in window order (LSB window first);
// out: 64-byte affine. Folds MANY results in one call (batch b): a
// batched commit returns hundreds of per-column window-sum vectors.
void pasta_window_fold(int which, const uint8_t* wsums, uint8_t* out,
                       int64_t b, int64_t n_windows, int64_t c_bits) {
    const FieldCtx* c = ctx_for(which);
#pragma omp parallel for schedule(static)
    for (int64_t bi = 0; bi < b; ++bi) {
        Pt acc;
        pt_identity(acc);
        const uint8_t* base = wsums + 64 * n_windows * bi;
        for (int64_t w = n_windows - 1; w >= 0; --w) {
            for (int64_t d = 0; d < c_bits; ++d) pt_double(c, acc, acc);
            Fe x, y;
            std::memcpy(&x, base + 64 * w, 32);
            std::memcpy(&y, base + 64 * w + 32, 32);
            if (!(fe_is_zero(x) && fe_is_zero(y))) {
                Fe xm, ym;
                fe_to_mont(c, xm, x);
                fe_to_mont(c, ym, y);
                pt_add_mixed(c, acc, acc, xm, ym);
            }
        }
        Fe ax, ay;
        pt_to_affine(c, ax, ay, acc);
        fe_from_mont(c, ax, ax);
        fe_from_mont(c, ay, ay);
        std::memcpy(out + 64 * bi, &ax, 32);
        std::memcpy(out + 64 * bi + 32, &ay, 32);
    }
}

// batched field ops; a, b, out: n * 32-byte LE canonical reprs
void pasta_mul_batch(int which, const uint8_t* a, const uint8_t* b, uint8_t* out, int64_t n) {
    const FieldCtx* c = ctx_for(which);
    for (int64_t i = 0; i < n; ++i) {
        Fe fa, fb, r;
        std::memcpy(&fa, a + 32 * i, 32);
        std::memcpy(&fb, b + 32 * i, 32);
        fe_to_mont(c, fa, fa);
        fe_to_mont(c, fb, fb);
        fe_mul(c, r, fa, fb);
        fe_from_mont(c, r, r);
        std::memcpy(out + 32 * i, &r, 32);
    }
}

// Montgomery batch inversion (one field inversion for n elements)
void pasta_inv_batch(int which, const uint8_t* a, uint8_t* out, int64_t n) {
    const FieldCtx* c = ctx_for(which);
    std::vector<Fe> vals(n), prefix(n);
    Fe acc = c->one;
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(&vals[i], a + 32 * i, 32);
        fe_to_mont(c, vals[i], vals[i]);
        prefix[i] = acc;
        fe_mul(c, acc, acc, vals[i]);
    }
    Fe inv;
    fe_inv(c, inv, acc);
    for (int64_t i = n - 1; i >= 0; --i) {
        Fe r;
        fe_mul(c, r, prefix[i], inv);
        fe_mul(c, inv, inv, vals[i]);
        fe_from_mont(c, r, r);
        std::memcpy(out + 32 * i, &r, 32);
    }
}

// Pippenger MSM: points n*64 bytes affine (identity = zeros), scalars
// n*32 bytes plain LE; out: 64 bytes affine.
void pasta_msm(int which, const uint8_t* points, const uint8_t* scalars, uint8_t* out, int64_t n) {
    const FieldCtx* c = ctx_for(which);
    // Signed-digit Pippenger with BATCH-AFFINE bucket accumulation (the
    // best_multiexp-class design, VERDICT r4 "verifier to ~10 ms"):
    //  * signed c-bit digits halve the bucket count (the sign rides as a
    //    y negation at insertion);
    //  * buckets are AFFINE; each scheduling pass performs at most one
    //    add per bucket, with every slope denominator inverted in ONE
    //    Montgomery batch inversion — an amortized affine add is ~6 muls
    //    vs ~11 for a mixed Jacobian add;
    //  * windows parallelize over OpenMP; the final Horner fold of window
    //    sums runs c_bits doublings per window on one thread.
    int c_bits = 4;
    while ((int64_t)1 << (c_bits + 3) < n && c_bits < 14) ++c_bits;
    // +1 window absorbs a carry out of the top digit (only reachable for
    // non-canonical >= 2^255 scalars; an all-zero extra window is free)
    const int n_windows = (256 + c_bits - 1) / c_bits + 1;
    const int32_t half = 1 << (c_bits - 1);

    std::vector<Fe> px((size_t)n), py((size_t)n), pny((size_t)n);
    std::vector<uint8_t> inf((size_t)n);
    Fe zero_fe = {{0, 0, 0, 0}};
    for (int64_t i = 0; i < n; ++i) {
        Fe x, y;
        std::memcpy(&x, points + 64 * i, 32);
        std::memcpy(&y, points + 64 * i + 32, 32);
        inf[i] = fe_is_zero(x) && fe_is_zero(y);
        if (!inf[i]) {
            fe_to_mont(c, px[i], x);
            fe_to_mont(c, py[i], y);
            fe_sub(c, pny[i], zero_fe, py[i]);
        }
    }

    // signed digit matrix: digits[w*n + i] in [-half, half]
    std::vector<int16_t> digits((size_t)n_windows * n, 0);
    const uint32_t mask = (1u << c_bits) - 1;
    for (int64_t i = 0; i < n; ++i) {
        if (inf[i]) continue;
        int32_t carry = 0;
        for (int w = 0; w < n_windows; ++w) {
            const int bit = w * c_bits;
            const int byte = bit >> 3;
            const int off = bit & 7;
            uint32_t chunk = 0;
            if (byte < 32) {
                const int span = byte > 28 ? 32 - byte : 4;
                std::memcpy(&chunk, scalars + 32 * i + byte, span);
            }
            int32_t d = (int32_t)((chunk >> off) & mask) + carry;
            if (d > half) {
                d -= 1 << c_bits;
                carry = 1;
            } else {
                carry = 0;
            }
            digits[(size_t)w * n + i] = (int16_t)d;
        }
        // carry out of the top window is impossible: scalars < 2^255 and
        // the top digit is far below `half` for every c_bits >= 5
    }

    std::vector<Pt> wsums(n_windows);
#pragma omp parallel for schedule(dynamic, 1)
    for (int w = 0; w < n_windows; ++w) {
        const int16_t* dr = &digits[(size_t)w * n];
        // counting sort of the window's nonzero digits by bucket magnitude
        std::vector<int32_t> cnt((size_t)half + 1, 0);
        for (int64_t i = 0; i < n; ++i) {
            int32_t d = dr[i];
            if (d && !inf[i]) ++cnt[(d < 0 ? -d : d) - 1];
        }
        std::vector<int32_t> start((size_t)half + 1, 0);
        for (int32_t b = 0; b < half; ++b) start[b + 1] = start[b] + cnt[b];
        const int32_t total = start[half];
        // bucket-sorted affine points, sign applied at materialization
        std::vector<Fe> xs((size_t)total), ys((size_t)total);
        std::vector<Fe> nx((size_t)total), ny((size_t)total);
        {
            std::vector<int32_t> cursor(start.begin(), start.end() - 1);
            for (int64_t i = 0; i < n; ++i) {
                int32_t d = dr[i];
                if (!d || inf[i]) continue;
                int32_t b = (d < 0 ? -d : d) - 1;
                int32_t pos = cursor[b]++;
                xs[pos] = px[i];
                ys[pos] = d < 0 ? pny[i] : py[i];
            }
        }
        std::vector<int32_t> len((size_t)half);
        for (int32_t b = 0; b < half; ++b) len[b] = cnt[b];
        // pairwise tree reduction: each round halves every bucket's point
        // count; ALL slopes of the round share one Montgomery batch
        // inversion. ~log2(max occupancy) rounds total.
        std::vector<int32_t> osrc, odst;
        std::vector<uint8_t> okind;
        std::vector<Fe> denom, dprefix;
        std::vector<int32_t> nstart((size_t)half + 1);
        bool more = true;
        while (more) {
            more = false;
            osrc.clear(); odst.clear(); okind.clear(); denom.clear();
            nstart[0] = 0;
            for (int32_t b = 0; b < half; ++b) {
                const int32_t s = start[b], l = len[b];
                int32_t wpos = nstart[b];
                for (int32_t k = 0; k + 1 < l; k += 2) {
                    const Fe& x1 = xs[s + k];
                    const Fe& y1 = ys[s + k];
                    const Fe& x2 = xs[s + k + 1];
                    const Fe& y2 = ys[s + k + 1];
                    if (std::memcmp(&x1, &x2, 32) == 0) {
                        if (std::memcmp(&y1, &y2, 32) == 0) {
                            Fe d2y;
                            fe_add(c, d2y, y1, y1);
                            osrc.push_back(s + k); odst.push_back(wpos++);
                            okind.push_back(1);
                            denom.push_back(d2y);
                        }
                        // else P + (-P): cancels, emit nothing
                        continue;
                    }
                    Fe dx;
                    fe_sub(c, dx, x2, x1);
                    osrc.push_back(s + k); odst.push_back(wpos++);
                    okind.push_back(0);
                    denom.push_back(dx);
                }
                if (l & 1) {  // odd survivor passes through
                    nx[wpos] = xs[s + l - 1];
                    ny[wpos] = ys[s + l - 1];
                    ++wpos;
                }
                len[b] = wpos - nstart[b];
                nstart[b + 1] = wpos;
                if (len[b] > 1) more = true;
            }
            const size_t m = denom.size();
            if (m) {
                dprefix.resize(m);
                Fe acc = c->one;
                for (size_t t = 0; t < m; ++t) {
                    dprefix[t] = acc;
                    fe_mul(c, acc, acc, denom[t]);
                }
                Fe inv;
                fe_inv(c, inv, acc);
                for (size_t t = m; t-- > 0;) {
                    Fe dinv;
                    fe_mul(c, dinv, dprefix[t], inv);
                    fe_mul(c, inv, inv, denom[t]);
                    const int32_t sidx = osrc[t];
                    const Fe& x1 = xs[sidx];
                    const Fe& y1 = ys[sidx];
                    const Fe& x2 = xs[sidx + 1];
                    Fe lam;
                    if (okind[t]) {
                        Fe xx, num;
                        fe_sqr(c, xx, x1);
                        fe_add(c, num, xx, xx);
                        fe_add(c, num, num, xx);  // 3x^2
                        fe_mul(c, lam, num, dinv);
                    } else {
                        Fe dy;
                        fe_sub(c, dy, ys[sidx + 1], y1);
                        fe_mul(c, lam, dy, dinv);
                    }
                    Fe x3, y3, t0;
                    fe_sqr(c, x3, lam);
                    fe_sub(c, x3, x3, x1);
                    fe_sub(c, x3, x3, x2);
                    fe_sub(c, t0, x1, x3);
                    fe_mul(c, y3, lam, t0);
                    fe_sub(c, y3, y3, y1);
                    nx[odst[t]] = x3;
                    ny[odst[t]] = y3;
                }
            }
            xs.swap(nx);
            ys.swap(ny);
            start.swap(nstart);
        }
        // bucket fold: running sum from the top magnitude down
        Pt running, wsum;
        pt_identity(running);
        pt_identity(wsum);
        for (int32_t b = half - 1; b >= 0; --b) {
            if (len[b]) pt_add_mixed(c, running, running, xs[start[b]], ys[start[b]]);
            pt_add(c, wsum, wsum, running);
        }
        wsums[w] = wsum;
    }

    Pt acc;
    pt_identity(acc);
    for (int w = n_windows - 1; w >= 0; --w) {
        for (int d = 0; d < c_bits; ++d) pt_double(c, acc, acc);
        pt_add(c, acc, acc, wsums[w]);
    }
    Fe ax, ay;
    pt_to_affine(c, ax, ay, acc);
    fe_from_mont(c, ax, ax);
    fe_from_mont(c, ay, ay);
    std::memcpy(out, &ax, 32);
    std::memcpy(out + 32, &ay, 32);
}

// Fixed-base window-table canonicity witness search (the halo2_gadgets
// find_zs analog, gadgets/fixed_bases.py): smallest z in [0, z_max) such
// that for all 8 window-point y values, y+z is a square (0 counts as
// square, matching fields/host.py is_square) and -y+z is a non-residue.
// ys: 8 * 32-byte LE canonical reprs. Returns -1 if no z < z_max.
int64_t pasta_find_z(int which, const uint8_t* ys, int64_t z_max) {
    const FieldCtx* c = ctx_for(which);
    Fe y[8], ny[8];
    Fe zero = {{0, 0, 0, 0}};
    for (int j = 0; j < 8; ++j) {
        std::memcpy(&y[j], ys + 32 * j, 32);
        fe_to_mont(c, y[j], y[j]);
        fe_sub(c, ny[j], zero, y[j]);
    }
    const int64_t CHUNK = 4096;
    for (int64_t base = 0; base < z_max; base += CHUNK) {
        int64_t end = base + CHUNK < z_max ? base + CHUNK : z_max;
        int64_t found = -1;
#pragma omp parallel
        {
            int64_t local = -1;
#pragma omp for nowait schedule(dynamic, 64)
            for (int64_t z = base; z < end; ++z) {
                Fe zf = {{(u64)z, 0, 0, 0}}, zm, t;
                fe_to_mont(c, zm, zf);
                bool ok = true;
                for (int j = 0; j < 8 && ok; ++j) {
                    fe_add(c, t, y[j], zm);
                    if (fe_legendre(c, t) < 0) { ok = false; break; }
                    fe_add(c, t, ny[j], zm);
                    if (fe_legendre(c, t) >= 0) ok = false;
                }
                if (ok && (local == -1 || z < local)) local = z;
            }
#pragma omp critical
            if (local != -1 && (found == -1 || local < found)) found = local;
        }
        if (found != -1) return found;
    }
    return -1;
}

// ---------------------------------------------------------------------------
// Latency-tier polynomial engine (ops/native_quotient.py and
// poly/transforms.py): batch radix-2 NTT, coset power scaling, and a
// bytecode VM executing the SAME instruction stream the device quotient
// evaluator runs (ops/gate_eval.py _VMEmitter). BZ_PROOF_ENGINE=auto routes
// every phase of a proof on a domain of at most BZ_LATENCY_N_MAX rows here
// (the game circuits, k=11/12); results are bit-identical to the device
// path (same exact field ops), pinned by the golden proof-byte tests.

// In-place batch forward NTT. data: b polynomials of n 32-byte LE canonical
// reprs; omega: 32-byte canonical root of unity of order n. Values stay in
// canonical form throughout: twiddles are kept in Montgomery form, so
// fe_mul(value_canonical, twiddle_mont) = value * twiddle (canonical).
void pasta_ntt_batch(int which, uint8_t* data, int64_t b, int64_t n, const uint8_t* omega_bytes) {
    const FieldCtx* c = ctx_for(which);
    if (n <= 1) return;
    Fe omega, omega_m;
    std::memcpy(&omega, omega_bytes, 32);
    fe_to_mont(c, omega_m, omega);
    int log_n = 0;
    while (((int64_t)1 << log_n) < n) ++log_n;
    std::vector<Fe> tw((size_t)(n / 2));
    tw[0] = c->one;
    for (int64_t i = 1; i < n / 2; ++i) fe_mul(c, tw[i], tw[i - 1], omega_m);
#pragma omp parallel
    {
        std::vector<Fe> buf((size_t)n);
#pragma omp for schedule(dynamic, 1)
    for (int64_t pi = 0; pi < b; ++pi) {
        Fe* a = buf.data();
        std::memcpy(a, data + (size_t)pi * n * 32, (size_t)n * 32);
        // bit-reversal permutation
        for (int64_t i = 0, j = 0; i < n; ++i) {
            if (j > i) std::swap(a[i], a[j]);
            int64_t bit = n >> 1;
            for (; j & bit; bit >>= 1) j ^= bit;
            j |= bit;
        }
        for (int s = 1; s <= log_n; ++s) {
            const int64_t m = (int64_t)1 << s, half = m >> 1;
            const int64_t stride = n / m;
            for (int64_t k0 = 0; k0 < n; k0 += m) {
                for (int64_t j = 0; j < half; ++j) {
                    Fe t, u = a[k0 + j];
                    fe_mul(c, t, a[k0 + j + half], tw[(size_t)(j * stride)]);
                    fe_add(c, a[k0 + j], u, t);
                    fe_sub(c, a[k0 + j + half], u, t);
                }
            }
        }
        std::memcpy(data + (size_t)pi * n * 32, a, (size_t)n * 32);
    }
    }
}

// data[j][i] *= mult * g^i for each of b polynomials of length n (canonical
// in/out). Covers coset scaling (g = coset generator, mult = 1), coset
// unscaling (g = g^-1, mult = 1/N) and plain iNTT normalization (g = 1).
void pasta_scale_batch(int which, uint8_t* data, int64_t b, int64_t n,
                       const uint8_t* g_bytes, const uint8_t* mult_bytes) {
    const FieldCtx* c = ctx_for(which);
    Fe g, gm, mult, mm;
    std::memcpy(&g, g_bytes, 32);
    std::memcpy(&mult, mult_bytes, 32);
    fe_to_mont(c, gm, g);
    fe_to_mont(c, mm, mult);
    std::vector<Fe> pw((size_t)n);
    pw[0] = mm;  // mont(mult * g^i): fe_mul(canonical, mont) -> canonical
    for (int64_t i = 1; i < n; ++i) fe_mul(c, pw[i], pw[i - 1], gm);
#pragma omp parallel for schedule(static) collapse(2)
    for (int64_t pi = 0; pi < b; ++pi) {
        for (int64_t i = 0; i < n; ++i) {
            Fe a;
            uint8_t* p = data + ((size_t)pi * n + i) * 32;
            std::memcpy(&a, p, 32);
            fe_mul(c, a, a, pw[i]);
            std::memcpy(p, &a, 32);
        }
    }
}

// Bytecode VM executor (the host twin of ops/gate_eval.py's lax.scan VM).
// prog: n_instr rows of (op, src_a, src_b, dst) int32 register indices with
// op 0=mul 1=add 2=sub; regs: n_regs * ext * 32-byte canonical reprs
// (register-major). Execution is row-blocked: every op is elementwise
// across the ext axis, so each block of rows runs the whole program on a
// thread-local Montgomery register file that stays cache-resident. On
// return `out` holds register 0 (the y-fold aggregate) in canonical form.
void pasta_vm_exec(int which, const int32_t* prog, int64_t n_instr,
                   const uint8_t* regs_bytes, int64_t n_regs, int64_t ext,
                   uint8_t* out) {
    const FieldCtx* c = ctx_for(which);
    const int64_t BLOCK = 256;
#pragma omp parallel
    {
        std::vector<Fe> regs((size_t)n_regs * BLOCK);
#pragma omp for schedule(dynamic, 1)
        for (int64_t r0 = 0; r0 < ext; r0 += BLOCK) {
            const int64_t len = (r0 + BLOCK <= ext) ? BLOCK : ext - r0;
            for (int64_t r = 0; r < n_regs; ++r) {
                const uint8_t* src = regs_bytes + ((size_t)r * ext + r0) * 32;
                Fe* dstv = &regs[(size_t)r * BLOCK];
                for (int64_t i = 0; i < len; ++i) {
                    std::memcpy(&dstv[i], src + (size_t)i * 32, 32);
                    fe_to_mont(c, dstv[i], dstv[i]);
                }
            }
            for (int64_t ins = 0; ins < n_instr; ++ins) {
                const int32_t op = prog[ins * 4];
                const Fe* a = &regs[(size_t)prog[ins * 4 + 1] * BLOCK];
                const Fe* bb = &regs[(size_t)prog[ins * 4 + 2] * BLOCK];
                Fe* d = &regs[(size_t)prog[ins * 4 + 3] * BLOCK];
                if (op == 0) {
                    for (int64_t i = 0; i < len; ++i) fe_mul(c, d[i], a[i], bb[i]);
                } else if (op == 1) {
                    for (int64_t i = 0; i < len; ++i) fe_add(c, d[i], a[i], bb[i]);
                } else {
                    for (int64_t i = 0; i < len; ++i) fe_sub(c, d[i], a[i], bb[i]);
                }
            }
            for (int64_t i = 0; i < len; ++i) {
                Fe r;
                fe_from_mont(c, r, regs[(size_t)i]);
                std::memcpy(out + (size_t)(r0 + i) * 32, &r, 32);
            }
        }
    }
}

// out[i] = a[i] * s + b[i] over canonical byte vectors — the Horner fold
// primitive of the multiopen / IPA host phases (poly_acc = poly_acc * x1
// + poly, p' = p_lo + u^-1 * p_hi, ...).
void pasta_axpy(int which, const uint8_t* a, const uint8_t* s_bytes,
                const uint8_t* b, uint8_t* out, int64_t n) {
    const FieldCtx* c = ctx_for(which);
    Fe s, sm;
    std::memcpy(&s, s_bytes, 32);
    fe_to_mont(c, sm, s);  // fe_mul(canonical, mont) -> canonical product
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        Fe fa, fb, r;
        std::memcpy(&fa, a + 32 * i, 32);
        std::memcpy(&fb, b + 32 * i, 32);
        fe_mul(c, r, fa, sm);
        fe_add(c, r, r, fb);
        std::memcpy(out + 32 * i, &r, 32);
    }
}

// Horner evaluation of an n-coefficient canonical-bytes polynomial at x.
void pasta_horner(int which, const uint8_t* coeffs, int64_t n,
                  const uint8_t* x_bytes, uint8_t* out) {
    const FieldCtx* c = ctx_for(which);
    Fe x, xm, acc = {{0, 0, 0, 0}};
    std::memcpy(&x, x_bytes, 32);
    fe_to_mont(c, xm, x);
    for (int64_t i = n - 1; i >= 0; --i) {
        Fe co;
        std::memcpy(&co, coeffs + 32 * i, 32);
        fe_mul(c, acc, acc, xm);  // canonical * mont -> canonical
        fe_add(c, acc, acc, co);
    }
    std::memcpy(out, &acc, 32);
}

// Inner product <a, b> of two canonical byte vectors.
void pasta_inner(int which, const uint8_t* a, const uint8_t* b,
                 int64_t n, uint8_t* out) {
    const FieldCtx* c = ctx_for(which);
    Fe total = {{0, 0, 0, 0}};
#pragma omp parallel
    {
        Fe local = {{0, 0, 0, 0}};
#pragma omp for schedule(static) nowait
        for (int64_t i = 0; i < n; ++i) {
            Fe fa, fb, r;
            std::memcpy(&fa, a + 32 * i, 32);
            std::memcpy(&fb, b + 32 * i, 32);
            fe_to_mont(c, fa, fa);
            fe_mul(c, r, fa, fb);  // mont * canonical -> canonical
            fe_add(c, local, local, r);
        }
#pragma omp critical
        fe_add(c, total, total, local);
    }
    std::memcpy(out, &total, 32);
}

// In-place synthetic division of poly by (X - point); the degree drops by
// one (the final slot is zeroed) and the remainder is returned through
// rem_out for the caller's exactness assertion.
void pasta_div_linear(int which, uint8_t* poly, int64_t n,
                      const uint8_t* point_bytes, uint8_t* rem_out) {
    const FieldCtx* c = ctx_for(which);
    Fe x, xm, rem = {{0, 0, 0, 0}};
    std::memcpy(&x, point_bytes, 32);
    fe_to_mont(c, xm, x);
    std::vector<Fe> src((size_t)n);
    std::memcpy(src.data(), poly, (size_t)n * 32);
    for (int64_t i = n - 1; i >= 0; --i) {
        Fe cur;
        fe_mul(c, cur, rem, xm);
        fe_add(c, cur, cur, src[(size_t)i]);
        if (i > 0) std::memcpy(poly + 32 * (i - 1), &cur, 32);
        rem = cur;
    }
    std::memset(poly + 32 * (n - 1), 0, 32);
    std::memcpy(rem_out, &rem, 32);
}

// Elementwise product of two canonical byte vectors (the h_ext * 1/Z_H
// step), OpenMP over rows — pasta_mul_batch without the list marshalling.
void pasta_mul_vec(int which, const uint8_t* a, const uint8_t* b, uint8_t* out, int64_t n) {
    const FieldCtx* c = ctx_for(which);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        Fe fa, fb, r;
        std::memcpy(&fa, a + 32 * i, 32);
        std::memcpy(&fb, b + 32 * i, 32);
        fe_to_mont(c, fa, fa);
        fe_to_mont(c, fb, fb);
        fe_mul(c, r, fa, fb);
        fe_from_mont(c, r, r);
        std::memcpy(out + 32 * i, &r, 32);
    }
}

}  // extern "C"
