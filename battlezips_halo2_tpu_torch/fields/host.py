"""Host-side (exact, arbitrary-precision) Pasta field arithmetic.

This is the bit-exact reference layer for the Pasta curve cycle fields used by
the whole framework:

* ``FP`` — the Pallas base field / Vesta scalar field
  (modulus cited in the reference at src/chips/bitify.rs:445-448).
* ``FQ`` — the Pallas scalar field / Vesta base field.

Field elements are plain Python ints in ``[0, modulus)``; byte representations
are 32-byte little-endian, matching ``ff::PrimeField::to_repr`` as consumed by
the reference (src/utils/binary.rs:35-59).

The device counterpart lives in ``fields/limb.py``; every device kernel
is tested against this module.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field

# Pallas base field modulus p (= Vesta scalar field).
# p = 2^254 + 45560315531419706090280762371685220353
P_PALLAS = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001

# Vesta base field modulus q (= Pallas scalar field).
# q = 2^254 + 45560315531506369815346746415080538113
Q_VESTA = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# Both Pasta fields have multiplicative generator 5 and 2-adicity S = 32
# (SURVEY.md §7.1: "ntt — radix-2 NTT/iNTT over Fp (2-adicity 32)").
PASTA_GENERATOR = 5
PASTA_TWO_ADICITY = 32


@dataclass(frozen=True)
class Field:
    """A prime field. Elements are ints in [0, modulus)."""

    modulus: int
    generator: int = PASTA_GENERATOR
    two_adicity: int = PASTA_TWO_ADICITY
    name: str = "F"
    # derived, filled in __post_init__
    root_of_unity: int = field(init=False, default=0)

    def __post_init__(self):
        t = (self.modulus - 1) >> self.two_adicity
        object.__setattr__(self, "root_of_unity", pow(self.generator, t, self.modulus))

    # --- basic arithmetic -------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.modulus

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.modulus

    def neg(self, a: int) -> int:
        return (-a) % self.modulus

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.modulus

    def sqr(self, a: int) -> int:
        return (a * a) % self.modulus

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    def inv(self, a: int) -> int:
        if a % self.modulus == 0:
            raise ZeroDivisionError("inversion of zero field element")
        return pow(a, -1, self.modulus)

    def batch_inv(self, xs: list[int]) -> list[int]:
        """Montgomery's batch-inversion trick: one inversion for N elements,
        on the native host engine when BZ_PROOF_ENGINE selects it."""
        n = len(xs)
        if n >= 64 and self.modulus in (P_PALLAS, Q_VESTA):
            from .. import native

            if native.enabled():
                xs = [x % self.modulus for x in xs]
                if not all(xs):
                    raise ZeroDivisionError("inversion of zero field element")
                return native.inv_batch(native.which_for(self.modulus), xs)
        prefix = [1] * (n + 1)
        for i, x in enumerate(xs):
            if x % self.modulus == 0:
                raise ZeroDivisionError("inversion of zero field element")
            prefix[i + 1] = prefix[i] * x % self.modulus
        acc = self.inv(prefix[n])
        out = [0] * n
        for i in range(n - 1, -1, -1):
            out[i] = prefix[i] * acc % self.modulus
            acc = acc * xs[i] % self.modulus
        return out

    # --- square roots -----------------------------------------------------
    def is_square(self, a: int) -> bool:
        a %= self.modulus
        if a == 0:
            return True
        return pow(a, (self.modulus - 1) >> 1, self.modulus) == 1

    def sqrt(self, a: int) -> int | None:
        """Tonelli–Shanks square root; returns None if `a` is a non-residue.

        The returned root is not sign-normalized; callers pick a root parity.
        """
        m = self.modulus
        a %= m
        if a == 0:
            return 0
        if not self.is_square(a):
            return None
        s = self.two_adicity
        t = (m - 1) >> s
        # z: generator of the 2-Sylow subgroup
        z = pow(self.generator, t, m)
        x = pow(a, (t + 1) >> 1, m)
        b = pow(a, t, m)
        while b != 1:
            # find least k with b^(2^k) == 1
            k, b2 = 0, b
            while b2 != 1:
                b2 = b2 * b2 % m
                k += 1
            # lift
            w = pow(z, 1 << (s - k - 1), m)
            z = w * w % m
            b = b * z % m
            x = x * w % m
            s = k
        return x

    # --- serialization ----------------------------------------------------
    def to_repr(self, a: int) -> bytes:
        """32-byte little-endian encoding (ff::PrimeField::to_repr)."""
        return (a % self.modulus).to_bytes(32, "little")

    def from_repr(self, data: bytes) -> int:
        """Strict decode; raises if the value is >= modulus (like from_repr)."""
        v = int.from_bytes(data, "little")
        if v >= self.modulus:
            raise ValueError("byte repr is not a canonical field element")
        return v

    def from_bytes_wide(self, data: bytes) -> int:
        """Reduce a 64-byte little-endian value (ff::FromUniformBytes)."""
        assert len(data) == 64
        return int.from_bytes(data, "little") % self.modulus

    def from_u128(self, v: int) -> int:
        assert 0 <= v < (1 << 128)
        return v  # both Pasta moduli exceed 2^128

    def random(self, rng=None) -> int:
        if rng is None:
            return int.from_bytes(secrets.token_bytes(64), "little") % self.modulus
        return rng.randrange(self.modulus)


FP = Field(P_PALLAS, name="Fp")
FQ = Field(Q_VESTA, name="Fq")
