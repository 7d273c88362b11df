"""Fixed-base scalar-multiplication window tables (85 x 3-bit windows).

Reverse-engineered semantics of the reference's precomputed tables
(src/utils/constants/fixed_bases/board_commit_{v,r}.rs, SURVEY.md §2.1),
verified numerically against the published Z/U data:

* window w < 84:  M[w][j] = [(j + 2) * 8^w] B   for j in 0..8
  (the +2 offset keeps incomplete additions well-defined)
* window 84:      M[84][j] = [j * 8^84 - OFFSET] B,
  OFFSET = sum_{i<84} 2 * 8^i  (undoes the accumulated offsets)
* Z[w] = smallest z >= 0 such that for all 8 window points (x, y):
  y + z is a QR and -y + z is not  (y-canonicity witness)
* U[w][j] = sqrt(y_j + Z[w])  (deterministic Tonelli-Shanks root, matches
  the ff crate's convention — verified byte-for-byte)

Per-window x-coordinates are compressed into a degree-7 Lagrange polynomial
whose 8 coefficients live in the fixed "Lagrange" columns of the ECC chip.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from .. import artifacts
from ..curves.host import PALLAS, Curve, Point
from ..fields.host import FP
from ..poly import lagrange_interpolate
from ..utils.constants import FIXED_BASE_WINDOW_SIZE, H, NUM_WINDOWS

OFFSET = sum(2 * 8**i for i in range(NUM_WINDOWS - 1))


def window_points(curve: Curve, base: Point, w: int) -> list[Point]:
    if w < NUM_WINDOWS - 1:
        return [curve.mul(base, (j + 2) * (8**w)) for j in range(H)]
    n = curve.scalar.modulus
    return [curve.mul(base, (j * 8 ** (NUM_WINDOWS - 1) - OFFSET) % n) for j in range(H)]


def _all_window_points(curve: Curve, base: Point) -> list[list[Point]]:
    """All NUM_WINDOWS x H window points with incremental group ops:
    S_w = [8^w]B via 3 doublings per window, row w = [(j+2)]S_w via one
    double + H-1 additions — ~11 affine ops/window instead of 8 full
    double-and-add scalar muls (each costing ~255 modular inversions);
    ~185x fewer inversions than the naive per-point build."""
    rows = []
    s = base  # [8^w] B
    for w in range(NUM_WINDOWS - 1):
        row = [curve.add(s, s)]  # [2] S_w
        for _ in range(H - 1):
            row.append(curve.add(row[-1], s))
        rows.append(row)
        d = curve.add(s, s)
        s = curve.add(curve.add(d, d), curve.add(d, d))  # [8] S_w
    n = curve.scalar.modulus
    last = [curve.mul(base, (-OFFSET) % n)]  # j = 0 term
    for _ in range(H - 1):
        last.append(curve.add(last[-1], s))  # + [8^84] B per j step
    rows.append(last)
    return rows


def find_z(ys: list[int], field=FP) -> int:
    """Smallest z making every y+z a QR and every -y+z a non-QR.

    Observed z values run to ~5*10^5 (reference board_commit tables), so
    production tables read their z witnesses from gadgets/data/*.json.
    When BZ_PROOF_ENGINE selects the native host engine the scan runs
    there (OpenMP over candidates)."""
    from .. import native

    if field.modulus in (native.FP_MODULUS, native.FQ_MODULUS) and native.enabled():
        z = native.find_z(native.which_for(field.modulus), [y % field.modulus for y in ys])
        if z is not None:
            return z
    z = 0
    while True:
        if all(field.is_square(y + z) and not field.is_square(field.neg(y) + z) for y in ys):
            return z
        z += 1


@dataclass(frozen=True)
class WindowTable:
    """Precomputed per-window data for one fixed base."""

    points: tuple  # 8 affine points
    lagrange_coeffs: tuple  # 8 coefficients of the x-interp polynomial
    z: int
    us: tuple  # 8 sqrt(y + z) witnesses


@dataclass(frozen=True)
class FixedBase:
    """A fixed generator plus its full window-table set."""

    name: str
    generator: Point
    windows: tuple  # NUM_WINDOWS WindowTables

    @staticmethod
    def build(name: str, generator: Point, zs: list[int] | None = None, curve: Curve = PALLAS) -> "FixedBase":
        """Build tables for a generator. If ``zs`` is given (e.g. from the
        reference tables), skip the z-search; otherwise derive from scratch."""
        windows = []
        all_pts = _all_window_points(curve, generator)
        for w in range(NUM_WINDOWS):
            pts = all_pts[w]
            ys = [p[1] for p in pts]
            z = zs[w] if zs is not None else find_z(ys)
            us = tuple(curve.base.sqrt((y + z) % curve.base.modulus) for y in ys)
            coeffs = tuple(lagrange_interpolate(list(range(H)), [p[0] for p in pts], curve.base))
            windows.append(WindowTable(tuple(pts), coeffs, z, us))
        return FixedBase(name, generator, tuple(windows))


def decompose_scalar(k: int) -> list[int]:
    """255-bit little-endian 3-bit window decomposition."""
    assert 0 <= k < (1 << (FIXED_BASE_WINDOW_SIZE * NUM_WINDOWS))
    return [(k >> (3 * w)) & 7 for w in range(NUM_WINDOWS)]


def mul_windows(curve: Curve, base_table: FixedBase, windows: list[int]) -> Point:
    """Host-side reference of the in-circuit mul: sum the window points."""
    acc: Point = None
    for w, kw in enumerate(windows):
        acc = curve.add(acc, base_table.windows[w].points[kw])
    return acc


def _derived_zs(name: str, generator: Point) -> list[int] | None:
    """z-witness lookup, keyed by the generator coordinates so a stale
    entry can never mismatch the base. Two locations, in order:

    1. the COMMITTED artifact (gadgets/data/fixed_base_zs_*.json) — the
       output of the from-scratch search, shipped so a fresh checkout
       without a C++ toolchain never falls into the pure-Python z-scan
       (z values run to ~5e5; hours per table in pure Python).
       Tests re-derive a sample from scratch and assert equality, so the
       committed file stays an artifact of our own search, not an input;
    2. the port's artifact store (artifacts.py), written by a previous
       in-tree search. A file there that fails to read is reported and
       searched again."""
    import json
    from pathlib import Path

    key = [str(k) for k in (generator[0], generator[1])]
    for cache in (Path(__file__).resolve().parent / "data" / f"fixed_base_zs_{name}.json", _zs_cache(name)):
        if cache.exists():
            try:
                data = json.loads(cache.read_text())
                if data.get("generator") == key:
                    return [int(z) for z in data["z"]]
            except (ValueError, KeyError) as exc:
                artifacts.report(cache, "unreadable, searching again", exc)
    return None


def _zs_cache(name: str):
    return artifacts.directory() / f"fixed_base_zs_{name}_v1.json"


def _save_zs(name: str, generator: Point, zs: list[int]) -> None:
    import json

    cache = _zs_cache(name)
    data = {"generator": [str(generator[0]), str(generator[1])], "z": zs}
    try:
        artifacts.write_atomic(cache, json.dumps(data).encode())
    except OSError as exc:
        artifacts.report(cache, "save failed", exc)


def _build_from_scratch(name: str, generator: Point) -> FixedBase:
    """Production table build with ZERO reference-derived inputs: window
    points from incremental group ops, z witnesses from the from-scratch
    search, u values from Tonelli-Shanks. The extracted
    reference JSON (utils/constants/reference_tables.json) is consumed only
    by tests, as a parity oracle (tests/test_ecc_pedersen.py asserts full
    byte-equality of these tables against it)."""
    zs = _derived_zs(name, generator)
    fb = FixedBase.build(name, generator, zs)
    if zs is None:
        _save_zs(name, generator, [w.z for w in fb.windows])
    return fb


@lru_cache(maxsize=None)
def board_commit_v() -> FixedBase:
    from ..utils.constants import BOARD_COMMIT_V_GENERATOR

    return _build_from_scratch("BoardCommitV", BOARD_COMMIT_V_GENERATOR)


@lru_cache(maxsize=None)
def board_commit_r() -> FixedBase:
    from ..utils.constants import BOARD_COMMIT_R_GENERATOR

    return _build_from_scratch("BoardCommitR", BOARD_COMMIT_R_GENERATOR)
