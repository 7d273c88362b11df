"""Host-side (exact) Pasta curve arithmetic: Pallas and Vesta.

Both curves have equation y^2 = x^3 + 5 and form a cycle:

* Pallas: points over Fp, scalar field Fq  — application-level Pedersen
  commitments live here (reference: src/utils/pedersen.rs:17-27).
* Vesta: points over Fq, scalar field Fp — the IPA commitment scheme's
  points (reference: ``Params::<vesta::Affine>`` at src/circuits/board.rs:907).

Points are affine (x, y) int tuples plus an identity sentinel; this layer is
the golden reference for the device (limb) kernels in ``curves/limb.py`` and
for SRS/table generation. Compressed encodings follow pasta_curves'
``GroupEncoding``: 32-byte LE x-coordinate with the y sign bit (y odd) in the
top bit of the last byte; identity = all zeros.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..fields.host import FP, FQ, Field

B_COEFF = 5

Point = Optional[Tuple[int, int]]  # None = point at infinity


@dataclass(frozen=True)
class Curve:
    name: str
    base: Field  # coordinate field
    scalar: Field  # group order field
    # generator (pasta_curves: (-1, 2) for both Pallas and Vesta)
    gx: int = -1
    gy: int = 2

    @property
    def generator(self) -> Point:
        return (self.gx % self.base.modulus, self.gy % self.base.modulus)

    # --- predicates -------------------------------------------------------
    def is_on_curve(self, p: Point) -> bool:
        if p is None:
            return True
        x, y = p
        f = self.base
        return f.sub(f.mul(y, y), f.add(f.mul(x, f.mul(x, x)), B_COEFF)) == 0

    # --- group law (affine, exact) ---------------------------------------
    def neg(self, p: Point) -> Point:
        if p is None:
            return None
        x, y = p
        return (x, self.base.neg(y))

    def add(self, p: Point, q: Point) -> Point:
        f = self.base
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if x1 == x2:
            if (y1 + y2) % f.modulus == 0:
                return None
            return self.double(p)
        lam = f.mul(f.sub(y2, y1), f.inv(f.sub(x2, x1)))
        x3 = f.sub(f.sub(f.mul(lam, lam), x1), x2)
        y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
        return (x3, y3)

    def double(self, p: Point) -> Point:
        if p is None:
            return None
        f = self.base
        x, y = p
        if y == 0:
            return None
        lam = f.mul(f.mul(3, f.mul(x, x)), f.inv(f.mul(2, y)))
        x3 = f.sub(f.mul(lam, lam), f.mul(2, x))
        y3 = f.sub(f.mul(lam, f.sub(x, x3)), y)
        return (x3, y3)

    def mul(self, p: Point, k: int) -> Point:
        """Double-and-add scalar multiplication (host reference path)."""
        k %= self.scalar.modulus
        acc: Point = None
        base = p
        while k:
            if k & 1:
                acc = self.add(acc, base)
            base = self.double(base)
            k >>= 1
        return acc

    def msm(self, points, scalars) -> Point:
        """Naive host MSM (golden reference for the device Pippenger kernel)."""
        acc: Point = None
        for p, s in zip(points, scalars):
            acc = self.add(acc, self.mul(p, s))
        return acc

    def pippenger(self, points, scalars, c: int = 8) -> Point:
        """Host Pippenger in exact Python ints (test oracle for ops/msm.py),
        on the native host engine when BZ_PROOF_ENGINE selects it."""
        if len(points) >= 32:
            from .. import native

            if native.enabled():
                # the native field is the COORDINATE field
                return native.msm(native.which_for(self.base.modulus), points,
                                  [s % self.scalar.modulus for s in scalars])
        n_windows = (256 + c - 1) // c
        mask = (1 << c) - 1
        acc: Point = None
        for w in range(n_windows - 1, -1, -1):
            if acc is not None:
                for _ in range(c):
                    acc = self.double(acc)
            buckets: dict[int, Point] = {}
            shift = c * w
            for p, s in zip(points, scalars):
                if p is None:
                    continue
                d = (int(s) >> shift) & mask
                if d:
                    buckets[d] = self.add(buckets.get(d), p)
            running: Point = None
            wsum: Point = None
            for d in range(max(buckets, default=0), 0, -1):
                running = self.add(running, buckets.get(d))
                wsum = self.add(wsum, running)
            acc = self.add(acc, wsum)
        return acc

    # --- encodings (pasta_curves GroupEncoding) ---------------------------
    def to_bytes(self, p: Point) -> bytes:
        if p is None:
            return b"\x00" * 32
        x, y = p
        data = bytearray(self.base.to_repr(x))
        data[31] |= (y & 1) << 7
        return bytes(data)

    def from_bytes(self, data: bytes) -> Point:
        assert len(data) == 32
        from .. import native

        if native.enabled():
            xy, status, bad = native.point_decompress(native.which_for(self.base.modulus), data)
            if bad >= 0:
                raise ValueError("invalid point encoding: x not on curve or not canonical")
            if status[0] == 1:
                return None
            return int.from_bytes(xy[0, :32].tobytes(), "little"), int.from_bytes(xy[0, 32:].tobytes(), "little")
        buf = bytearray(data)
        ysign = (buf[31] >> 7) & 1
        buf[31] &= 0x7F
        x = self.base.from_repr(bytes(buf))
        if x == 0 and ysign == 0:
            return None
        y2 = self.base.add(self.base.mul(x, self.base.mul(x, x)), B_COEFF)
        y = self.base.sqrt(y2)
        if y is None:
            raise ValueError("invalid point encoding: x not on curve")
        if (y & 1) != ysign:
            y = self.base.neg(y)
        return (x, y)

    def from_xy_bytes(self, xb: bytes, yb: bytes) -> Point:
        """Decode an uncompressed affine pair of 32-byte LE reprs, as stored
        in the reference's fixed-base tables (board_commit_v.rs:5-15)."""
        x = self.base.from_repr(xb)
        y = self.base.from_repr(yb)
        p = (x, y)
        if not self.is_on_curve(p):
            raise ValueError("(x, y) not on curve")
        return p


PALLAS = Curve("pallas", base=FP, scalar=FQ)
VESTA = Curve("vesta", base=FQ, scalar=FP)
