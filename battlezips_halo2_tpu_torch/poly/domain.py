"""Evaluation domain for PLONK polynomials over Fp.

Framework analog of ``halo2_proofs::poly::EvaluationDomain`` (SURVEY.md §2.2
"Radix-2 FFT/NTT"): a 2^k-point multiplicative subgroup domain with an
extended coset domain (for the quotient polynomial), Lagrange<->coefficient
conversion, and analytic Lagrange-basis evaluation.

This module is the host-exact layer (Python ints, used for golden tests and
small/verifier-side work); the device kernels live in ops/ntt.py and are
bit-exact against this.
"""

from __future__ import annotations

from functools import lru_cache

from ..fields.host import FP, Field


def bit_reverse(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def ntt_host(values: list[int], omega: int, field: Field = FP) -> list[int]:
    """In-order iterative radix-2 Cooley-Tukey NTT (DIT). Output in natural
    order: out[j] = sum_i values[i] * omega^(i*j)."""
    n = len(values)
    assert n & (n - 1) == 0
    m = field.modulus
    logn = n.bit_length() - 1
    a = [values[bit_reverse(i, logn)] for i in range(n)]
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, m)
        half = length // 2
        for start in range(0, n, length):
            w = 1
            for j in range(half):
                u = a[start + j]
                v = a[start + j + half] * w % m
                a[start + j] = (u + v) % m
                a[start + j + half] = (u - v) % m
                w = w * w_len % m
        length *= 2
    return a


def intt_host(values: list[int], omega: int, field: Field = FP) -> list[int]:
    n = len(values)
    inv_n = field.inv(n)
    out = ntt_host(values, field.inv(omega), field)
    return [v * inv_n % field.modulus for v in out]


class EvaluationDomain:
    """n = 2^k row domain with an extended coset of size n * 2^ext_bits."""

    def __init__(self, k: int, quotient_degree: int, field: Field = FP):
        self.field = field
        self.k = k
        self.n = 1 << k
        # quotient poly needs degree (d-1)*n => extended size next pow2 >= (d-1)
        ext_factor = 1
        ext_bits = 0
        while ext_factor < max(1, quotient_degree - 1):
            ext_factor <<= 1
            ext_bits += 1
        self.extended_k = k + ext_bits
        self.extended_n = 1 << self.extended_k
        m = field.modulus
        s = field.two_adicity
        root = field.root_of_unity  # order 2^S
        self.omega = pow(root, 1 << (s - k), m)
        self.omega_inv = field.inv(self.omega)
        self.extended_omega = pow(root, 1 << (s - self.extended_k), m)
        self.extended_omega_inv = field.inv(self.extended_omega)
        # coset generator: the field's multiplicative generator (zeta)
        self.g_coset = field.generator
        self.g_coset_inv = field.inv(self.g_coset)

    # --- basis conversion (host-exact) ------------------------------------
    def lagrange_to_coeff(self, values: list[int]) -> list[int]:
        assert len(values) == self.n
        return intt_host(values, self.omega, self.field)

    def coeff_to_lagrange(self, coeffs: list[int]) -> list[int]:
        assert len(coeffs) == self.n
        return ntt_host(coeffs, self.omega, self.field)

    def coeff_to_extended(self, coeffs: list[int]) -> list[int]:
        """Evaluate a (< extended_n)-degree poly on the extended coset
        { g * ext_omega^i }."""
        m = self.field.modulus
        padded = list(coeffs) + [0] * (self.extended_n - len(coeffs))
        # scale by coset powers: p(g*X) coefficients
        g_pow = 1
        for i in range(len(padded)):
            padded[i] = padded[i] * g_pow % m
            g_pow = g_pow * self.g_coset % m
        return ntt_host(padded, self.extended_omega, self.field)

    def extended_to_coeff(self, evals: list[int]) -> list[int]:
        m = self.field.modulus
        coeffs = intt_host(evals, self.extended_omega, self.field)
        g_pow = 1
        for i in range(len(coeffs)):
            coeffs[i] = coeffs[i] * g_pow % m
            g_pow = g_pow * self.g_coset_inv % m
        return coeffs

    # --- analytic helpers -------------------------------------------------
    def t_extended(self) -> list[int]:
        """Z_H(X) = X^n - 1 evaluated over the extended coset (invertible)."""
        m = self.field.modulus
        # (g * w^i)^n - 1 = g^n * (w^n)^i - 1 ; w^n has order ext_n/n
        gn = pow(self.g_coset, self.n, m)
        wn = pow(self.extended_omega, self.n, m)
        out = []
        acc = gn
        for _ in range(self.extended_n):
            out.append((acc - 1) % m)
            acc = acc * wn % m
        return out

    def eval_vanishing(self, x: int) -> int:
        return (pow(x, self.n, self.field.modulus) - 1) % self.field.modulus

    def eval_lagrange(self, i: int, x: int) -> int:
        """l_i(x) = omega^i * (x^n - 1) / (n * (x - omega^i))."""
        m = self.field.modulus
        wi = pow(self.omega, i, m)
        num = wi * self.eval_vanishing(x) % m
        den = self.n * (x - wi) % m
        return num * self.field.inv(den) % m

    def rotate_point(self, x: int, rotation: int) -> int:
        m = self.field.modulus
        w = self.omega if rotation >= 0 else self.omega_inv
        return x * pow(w, abs(rotation), m) % m


def eval_poly_coeffs(coeffs: list[int], x: int, field: Field = FP) -> int:
    """Horner evaluation. A coefficient list that carries its bytes
    (poly/polyints.py::PolyInts, which only the native host engine's routes
    make) is evaluated on that engine."""
    pre = getattr(coeffs, "bytes_arr", None)
    if pre is not None and field is FP:
        from .. import native

        return native.horner(native.which_for(field.modulus), pre, x % field.modulus)
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % field.modulus
    return acc


@lru_cache(maxsize=None)
def domain_for(k: int, quotient_degree: int) -> EvaluationDomain:
    return EvaluationDomain(k, quotient_degree)
