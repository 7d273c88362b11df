"""Inner-product-argument polynomial commitment scheme over Vesta.

Framework analog of ``halo2_proofs::poly::commitment``: deterministic SRS,
blinded Pedersen vector commitments (every commitment is a device MSM over
[G | W]), and the log-n inner-product opening argument in halo2 0.2.0's
exact shape (synthetic-blinding S commitment, xi/z challenges, asymmetric
folds; see create_open_proof / verify_open_proof for the round equations).

SRS derivation follows halo2 0.2.0: hash_to_curve("Halo2-Parameters") on
Vesta through the SSWU map of curves/hashtocurve.py.

``Params`` carries the device every commitment runs on; its G | W point
table is uploaded once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..curves import limb as C
from ..curves.host import VESTA, Point
from ..fields.host import FP
from ..fields.limb import FieldSpec, NLIMBS, ints_to_limbs, limbs_to_ints
from ..ops.cuda import resolve_device
from ..ops.msm import msm, msm_many_table
from ..plonk.transcript import TranscriptRead, TranscriptWrite

P = FP.modulus
VESTA_BASE = FieldSpec.make(VESTA.base.modulus)


@dataclass
class Params:
    """SRS for circuits up to 2^k rows: G vector, U (inner-product base),
    W (blinding base), and the device that commits with them."""

    k: int
    g: list  # n Vesta points
    u: Point
    w: Point
    device: torch.device
    _gw_table: torch.Tensor | None = field(default=None, repr=False)

    @staticmethod
    def new(k: int, device=None) -> "Params":
        """halo2 0.2.0 ``Params::new``: every point is
        hash_to_curve("Halo2-Parameters") on Vesta; G_i from the u32 LE
        index bytes, W and U from b"w" / b"u"."""
        from ..curves.hashtocurve import hash_to_curve

        hasher = hash_to_curve(VESTA, "Halo2-Parameters")
        g = [hasher(i.to_bytes(4, "little")) for i in range(1 << k)]
        return Params(k, g, hasher(b"u"), hasher(b"w"), resolve_device(device))

    @property
    def n(self) -> int:
        return 1 << self.k

    def gw_table(self) -> torch.Tensor:
        """(n + 1, 2, 8) device table of [G | W] (curves/limb.py::affine_table)."""
        if self._gw_table is None:
            self._gw_table = C.affine_table(VESTA_BASE, self.g + [self.w], self.device)
        return self._gw_table

    def g_table(self) -> torch.Tensor:
        return self.gw_table()[: self.n]


def _commit_limbs(params: Params, coeffs: torch.Tensor, blinds: list) -> list[Point]:
    """<coeffs_i, G> + [blind_i] W for a (B, <= n, 8) canonical coefficient
    tensor: one batched device MSM over [G | W]."""
    b = coeffs.shape[0]
    scalars = torch.zeros(b, params.n + 1, NLIMBS, dtype=torch.int32, device=params.device)
    scalars[:, : coeffs.shape[1]] = coeffs
    scalars[:, params.n] = ints_to_limbs([v % P for v in blinds], params.device)
    return msm_many_table(VESTA, params.gw_table(), scalars)


def _groups(count: int, chunk: int | None):
    """[start, stop) spans of at most ``chunk`` items (None: one span)."""
    step = count if chunk is None else chunk
    if step < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return [(i, min(i + step, count)) for i in range(0, count, step)]


def commit_many(params: Params, polys: list, blinds: list, chunk: int | None = None) -> list[Point]:
    """Commit a batch of coefficient polynomials (each <= n long), ``chunk``
    of them per batched device MSM (None: all at once)."""
    assert len(polys) == len(blinds)
    if not polys:
        return []
    assert all(len(p) <= params.n for p in polys)
    points = []
    for a, b in _groups(len(polys), chunk):
        flat = []
        for p in polys[a:b]:
            flat += [v % P for v in p] + [0] * (params.n - len(p))
        coeffs = ints_to_limbs(flat, params.device).reshape(b - a, params.n, NLIMBS)
        points += _commit_limbs(params, coeffs, blinds[a:b])
    return points


def commit(params: Params, coeffs: list[int], blind: int) -> Point:
    """<coeffs, G> + [blind] W."""
    return commit_many(params, [coeffs], [blind])[0]


def commit_lagrange_many(params: Params, domain, values_list: list, blinds: list, chunk: int | None = None):
    """Lagrange columns -> (coefficient polys, commitments): per group of
    ``chunk`` columns (None: all at once) the iNTT and the commitment MSMs
    run on the device in one pass, and the coefficients come back to the
    host once."""
    from ..poly.transforms import lagrange_to_coeff_limbs

    assert len(values_list) == len(blinds)
    if not values_list:
        return [], []
    n = domain.n
    assert all(len(v) == n for v in values_list)
    polys, points = [], []
    for a, b in _groups(len(values_list), chunk):
        flat = [x % P for v in values_list[a:b] for x in v]
        vals = ints_to_limbs(flat, params.device).reshape(b - a, n, NLIMBS)
        coeffs = lagrange_to_coeff_limbs(domain, vals)
        ints = limbs_to_ints(coeffs)
        polys += [ints[i : i + n] for i in range(0, len(ints), n)]
        points += _commit_limbs(params, coeffs, blinds[a:b])
    return polys, points


def lagrange_basis_commitment(params: Params, domain, row: int) -> Point:
    """G_lag_row = commit(L_row, 0), cached per (params, row): lets the
    verifier commit a sparse instance column as a few scalar-muls.
    L_row(X) = (1/n) sum_i omega^(-row i) X^i."""
    cache = getattr(params, "_lagrange_basis_commits", None)
    if cache is None:
        cache = params._lagrange_basis_commits = {}
    if row not in cache:
        w_inv = pow(domain.omega, -(row % domain.n), P)
        scalars, acc = [], pow(domain.n, -1, P)
        for _ in range(domain.n):
            scalars.append(acc)
            acc = acc * w_inv % P
        cache[row] = commit(params, scalars, 0)
    return cache[row]


def commit_lagrange_sparse(params: Params, domain, values: list) -> Point:
    """Commitment of a Lagrange-basis column with blind 0, as
    sum_{v_i != 0} [v_i] G_lag_i: the same group element as
    commit(lagrange_to_coeff(values), 0). Callers gate on a small nonzero
    count."""
    points, scalars = [], []
    for i, v in enumerate(values):
        if v % P:
            points.append(lagrange_basis_commitment(params, domain, i))
            scalars.append(v % P)
    if not points:
        return None
    return msm(VESTA, points, scalars, params.device)


def create_open_proof(
    params: Params,
    transcript: TranscriptWrite,
    coeffs: list[int],
    blind: int,
    x: int,
    rng,
):
    """Open the committed polynomial at x (the value p(x) is already known
    to the verifier through the transcript).

    halo2 0.2.0 structure (poly/commitment/prover.rs create_proof):

    1. commit a random polynomial S with a root at x (written), squeeze xi
       (binds P to S) and z (guards the U term);
    2. fold P' = xi S + P with its constant term shifted so P'(x) = 0;
    3. k rounds:  L_j = <p'_hi, G'_lo> + [z <p'_hi, b_lo>] U + [l_rand] W,
                  R_j = <p'_lo, G'_hi> + [z <p'_lo, b_hi>] U + [r_rand] W,
       squeeze u_j, fold p' <- p'_lo + u_j^-1 p'_hi, b <- b_lo + u_j b_hi,
       G' <- G'_lo + u_j G'_hi;
    4. write a = p'_final and the synthetic blind
       f = blind' + sum (u_j^-1 l_rand_j + u_j r_rand_j).

    The folded G' is never materialised: each folded entry is a u-power
    product of original G points, so every round's L / R point parts are
    one batched device MSM over the ORIGINAL G with composite scalars
    (c = accumulated u-powers, pos = current fold position)."""
    m = P
    n = params.n
    p_prime = np.zeros(n, dtype=object)
    p_prime[: len(coeffs)] = [c % m for c in coeffs]
    b = np.empty(n, dtype=object)
    acc = 1
    for i in range(n):
        b[i] = acc
        acc = acc * x % m

    s_poly = [FP.random(rng) for _ in range(n)]
    s_at_x = 0
    for c in reversed(s_poly):
        s_at_x = (s_at_x * x + c) % m
    s_poly[0] = (s_poly[0] - s_at_x) % m
    s_blind = FP.random(rng)
    transcript.write_point(commit(params, s_poly, s_blind))

    xi = transcript.squeeze_challenge()
    z = transcript.squeeze_challenge()

    s_arr = np.empty(n, dtype=object)
    s_arr[:] = s_poly
    p_prime = (xi * s_arr + p_prime) % m
    v = int(np.sum(p_prime * b)) % m  # p'(x) before the shift
    p_prime[0] = (p_prime[0] - v) % m
    f = (blind + xi * s_blind) % m

    c_coeff = np.ones(n, dtype=object)
    pos = np.arange(n)
    length = n
    while length > 1:
        half = length // 2
        p_lo, p_hi = p_prime[:half], p_prime[half:length]
        b_lo, b_hi = b[:half], b[half:length]

        l_rand = FP.random(rng)
        r_rand = FP.random(rng)
        value_l = int(np.sum(p_hi * b_lo)) % m
        value_r = int(np.sum(p_lo * b_hi)) % m

        # an original index i sits at fold position pos_i with coefficient c_i:
        #   <p'_hi, G'_lo> = sum_{pos_i <  half} c_i p'[pos_i + half] G_i
        #   <p'_lo, G'_hi> = sum_{pos_i >= half} c_i p'[pos_i - half] G_i
        hi_mask = pos >= half
        v_l = np.where(~hi_mask, c_coeff * p_prime[np.where(~hi_mask, pos + half, 0)] % m, 0)
        v_r = np.where(hi_mask, c_coeff * p_prime[np.where(hi_mask, pos - half, 0)] % m, 0)
        scalars = ints_to_limbs([int(t) for t in v_l] + [int(t) for t in v_r], params.device)
        base_l, base_r = msm_many_table(VESTA, params.g_table(), scalars.reshape(2, n, NLIMBS))
        uw = [params.u, params.w]
        L = msm(VESTA, [base_l] + uw, [1, value_l * z % m, l_rand], params.device)
        R = msm(VESTA, [base_r] + uw, [1, value_r * z % m, r_rand], params.device)
        transcript.write_point(L)
        transcript.write_point(R)
        u = transcript.squeeze_challenge_nonzero()
        u_inv = FP.inv(u)

        p_prime = (p_lo + u_inv * p_hi) % m
        b = (b_lo + u * b_hi) % m
        c_coeff = np.where(hi_mask, c_coeff * u % m, c_coeff)
        pos = np.where(hi_mask, pos - half, pos)
        f = (f + u_inv * l_rand + u * r_rand) % m
        length = half

    transcript.write_scalar(int(p_prime[0]))
    transcript.write_scalar(f)


def verify_open_proof(
    params: Params,
    transcript: TranscriptRead,
    commitment: Point,
    x: int,
    value: int,
) -> bool:
    """Verify an opening; one n-point device MSM for G_final plus O(log n)
    point terms.

    halo2 0.2.0 structure (poly/commitment/verifier.rs): read S, squeeze
    xi and z, read k (L, R, u_j) rounds, then check

        [a] G_fin + [a b_fin z] U + [f] W
            == P - [v] G_0 + [xi] S + sum_j ([u_j^-1] L_j + [u_j] R_j)

    with b_fin = prod_j (1 + u_j x^(n / 2^(j+1))) and s_i = prod_{j: bit} u_j
    (the G' fold multiplies high halves by u_j and leaves low halves)."""
    m = P
    n = params.n
    s_commitment = transcript.read_point()
    xi = transcript.squeeze_challenge()
    z = transcript.squeeze_challenge()

    ls, rs, us = [], [], []
    for _ in range(params.k):
        ls.append(transcript.read_point())
        rs.append(transcript.read_point())
        us.append(transcript.squeeze_challenge_nonzero())
    a0 = transcript.read_scalar()
    f_final = transcript.read_scalar()

    b_final = 1
    half = n // 2
    for u in us:
        b_final = b_final * ((1 + u * pow(x, half, m)) % m) % m
        half //= 2

    s = np.ones(n, dtype=object)
    idx = np.arange(n)
    half = n // 2
    for u in us:
        s = np.where((idx & half).astype(bool), s * u % m, s)
        half //= 2
    lhs_scalars = [int(v) for v in a0 * s % m] + [a0 * b_final % m * z % m, f_final]
    lhs = msm(VESTA, params.g + [params.u, params.w], lhs_scalars, params.device)

    rhs_pts = [commitment, params.g[0], s_commitment]
    rhs_scalars = [1, (-value) % m, xi]
    for L, R, u in zip(ls, rs, us):
        rhs_pts += [L, R]
        rhs_scalars += [FP.inv(u), u]
    rhs = msm(VESTA, rhs_pts, rhs_scalars, params.device)
    return lhs == rhs
