"""The field arithmetic of battlezips_halo2_tpu_torch/csrc/field.cuh on the
CPU: the header is compiled with g++, its PTX carry-chain helpers replaced
by C++ that keeps the carry flag in a variable, one helper per PTX
instruction with the instruction's semantics. The carry-chain forms
(BZ_FE_CARRY_CHAIN, which K8 and K9 use) and the 64-bit forms (K1-K7) of
the Montgomery product, add, sub and REDC, and K8's incomplete mixed
addition, are held against Python integers at edge and random values of
both Pasta fields, exactly. Without g++ the tests skip."""

import random
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from battlezips_halo2_tpu_torch.curves.host import PALLAS, VESTA
from battlezips_halo2_tpu_torch.fields import limb as L

FIELD_CUH = Path(__file__).resolve().parent.parent / "battlezips_halo2_tpu_torch" / "csrc" / "field.cuh"
R = 1 << 256

# PTX semantics: .cc writes the carry (for sub, the borrow) out, c reads it in
EMULATED = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#define __device__
#define __forceinline__ inline
#define __noinline__
struct uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
static inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
typedef void* cudaStream_t;
static uint64_t CF = 0;
static inline uint32_t cc_add(uint32_t a, uint32_t b) { uint64_t s = (uint64_t)a + b; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t cc_addc(uint32_t a, uint32_t b) { uint64_t s = (uint64_t)a + b + CF; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t addc_end(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a + b + CF); }
static inline uint32_t cc_sub(uint32_t a, uint32_t b) { uint64_t s = (uint64_t)a - b; CF = (s >> 63) & 1; return (uint32_t)s; }
static inline uint32_t cc_subc(uint32_t a, uint32_t b) { uint64_t s = (uint64_t)a - b - CF; CF = (s >> 63) & 1; return (uint32_t)s; }
static inline uint32_t subc_end(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a - b - CF); }
static inline uint32_t cc_mad_lo(uint32_t a, uint32_t b, uint32_t c) { uint64_t s = (uint64_t)(uint32_t)(a * b) + c; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t cc_madc_lo(uint32_t a, uint32_t b, uint32_t c) { uint64_t s = (uint64_t)(uint32_t)(a * b) + c + CF; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t cc_madc_hi(uint32_t a, uint32_t b, uint32_t c) { uint64_t s = (((uint64_t)a * b) >> 32) + c + CF; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t madc_hi_end(uint32_t a, uint32_t b, uint32_t c) { return (uint32_t)((((uint64_t)a * b) >> 32) + c + CF); }
"""
HELPERS = ("cc_add", "cc_addc", "addc_end", "cc_sub", "cc_subc", "subc_end",
           "cc_mad_lo", "cc_madc_lo", "cc_madc_hi", "madc_hi_end")
MAIN = r"""
static void rd(Fe& x) { for (int i = 0; i < 8; ++i) if (scanf("%x", &x.v[i]) != 1) exit(1); }
static void pr(const Fe& x) { for (int i = 0; i < 8; ++i) printf("%08x ", x.v[i]); }
// stdin: the 17 kernel constants, then lines "f a b" (f: m mul, a add, s sub,
// r redc of a) or "k X Y Z qx qy" (K8's incomplete mixed addition)
int main() {
  uint32_t w[17];
  for (int i = 0; i < 17; ++i) if (scanf("%x", &w[i]) != 1) return 1;
  const FieldConsts F = field_consts(w);
  char op;
  while (scanf(" %c", &op) == 1) {
    if (op == 'k') {
      Jac p; Fe qx, qy; rd(p.x); rd(p.y); rd(p.z); rd(qx); rd(qy);
      bool flag;
      const Jac o = jac_add_mixed<false>(F, p, qx, qy, fe_is_zero(qx) && fe_is_zero(qy), flag);
      pr(o.x); pr(o.y); pr(o.z);
    } else {
      Fe a, b; rd(a); rd(b);
      pr(op == 'm' ? fe_mul(F, a, b) : op == 'a' ? fe_add(F, a, b) : op == 's' ? fe_sub(F, a, b) : fe_redc(F, a));
    }
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module", params=["carry chain", "64-bit"])
def emulated(request, tmp_path_factory):
    """The path of a CPU build of field.cuh's arithmetic, in either form."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/field.cuh on the CPU")
    text = FIELD_CUH.read_text().replace("#include <cuda_runtime.h>", "")
    for name in HELPERS:
        text, k = re.subn(r"__device__ __forceinline__ uint32_t %s\([^)]*\) \{.*?\n\}\n" % name, "", text, flags=re.S)
        assert k == 1, f"field.cuh has no single PTX helper {name}"
    out = tmp_path_factory.mktemp("field_cuh")
    define = "#define BZ_FE_CARRY_CHAIN\n" if request.param == "carry chain" else ""
    (out / "emulated.cpp").write_text(EMULATED + define + text + MAIN)
    subprocess.run([gxx, "-O1", "-std=c++17", "-o", str(out / "field"), str(out / "emulated.cpp")], check=True,
                   capture_output=True, timeout=300)
    return out / "field"


def _words(x: int) -> str:
    return " ".join("%08x" % ((x >> (32 * i)) & 0xFFFFFFFF) for i in range(8))


def _run(binary, spec, lines) -> list[list[int]]:
    stdin = " ".join("%08x" % w for w in spec.kernel_consts) + "\n" + "\n".join(lines) + "\n"
    out = subprocess.run([str(binary)], input=stdin, capture_output=True, text=True, check=True, timeout=300).stdout
    rows = []
    for line in out.splitlines():
        w = line.split()
        rows.append([sum(int(w[8 * k + i], 16) << (32 * i) for i in range(8)) for k in range(len(w) // 8)])
    return rows


def _values(spec, rng) -> list[int]:
    """Edge values (0, 1, p - 1, R mod p, limbs of all ones below p, p less a
    power of 2^32) and random values, some just below p."""
    p = spec.modulus
    edge = [0, 1, 2, p - 1, p - 2, spec.r_mod_p, (p + 1) // 2, (1 << 254) - 1]
    edge += [(1 << (32 * k)) - 1 for k in range(1, 8)] + [p - (1 << (32 * k)) for k in range(1, 8)]
    return edge + [rng.randrange(p) for _ in range(40)] + [p - 1 - rng.randrange(1 << 128) for _ in range(20)]


@pytest.mark.parametrize("spec", [L.FP_SPEC, L.FQ_SPEC], ids=["Fp", "Fq"])
def test_field_ops_against_host_ints(emulated, spec):
    p, rng = spec.modulus, random.Random(spec.name)
    vals = _values(spec, rng)
    pairs = [(a, b) for a in vals[:22] for b in vals[:22]] + [(rng.choice(vals), rng.choice(vals)) for _ in range(800)]
    r_inv = pow(R, -1, p)
    want = {"m": lambda a, b: a * b * r_inv % p, "a": lambda a, b: (a + b) % p,
            "s": lambda a, b: (a - b) % p, "r": lambda a, b: a * r_inv % p}
    for op, fn in want.items():
        got = _run(emulated, spec, [f"{op} {_words(a)} {_words(b)}" for a, b in pairs])
        assert [g[0] for g in got] == [fn(a, b) for a, b in pairs], op


@pytest.mark.parametrize("spec", [L.FP_SPEC, L.FQ_SPEC], ids=["Fp", "Fq"])
def test_k8_mixed_addition_against_host_law(emulated, spec):
    """jac_add_mixed<false> (K8's step) in Montgomery form: P + Q by the
    group law, the identity cases, and the excluded P == Q case's (0, 0, 0)."""
    p, rng = spec.modulus, random.Random(spec.name)
    curve = VESTA if spec is L.FQ_SPEC else PALLAS  # the curve whose base field this is
    cases, lines = [], []
    for k in range(60):
        q = curve.mul(curve.generator, rng.randrange(1, 1 << 62))
        acc = q if k % 5 == 0 else curve.mul(curve.generator, rng.randrange(1, 1 << 62))
        acc = None if k % 7 == 3 else acc
        q = None if k % 11 == 4 else q
        z = rng.randrange(1, p)
        X, Y, Z = (1, 1, 0) if acc is None else (acc[0] * z * z % p, acc[1] * z ** 3 % p, z)
        qx, qy = (0, 0) if q is None else (q[0] * R % p, q[1] * R % p)
        cases.append((acc, q))
        lines.append("k " + " ".join(_words(v * R % p) for v in (X, Y, Z)) + f" {_words(qx)} {_words(qy)}")
    r_inv = pow(R, -1, p)
    for (acc, q), (X, Y, Z) in zip(cases, _run(emulated, spec, lines)):
        if acc is not None and q is not None and acc == q:
            assert (X, Y, Z) == (0, 0, 0)
            continue
        want = curve.add(acc, q)
        if want is None:
            assert Z == 0
        else:
            x, y, z = (v * r_inv % p for v in (X, Y, Z))
            zi = pow(z, -1, p)
            assert (x * zi * zi % p, y * zi ** 3 % p) == want
