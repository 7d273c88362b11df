"""Multi-point batch opening for the IPA PCS.

Framework analog of ``halo2_proofs::poly::multiopen`` (SURVEY.md §2.2 "IPA
commitment scheme — multiopen (batched quotient trick)"): queries are
grouped by point set, combined by Horner folds in x1 within a set, the
quotient aggregate f(X) = Horner_x2 over sets of (q_i - r_i)/prod(X - p)
is committed, q_i(x3) evals are revealed, and a single IPA opening of
Horner_x4(f, q_0, ..., q_{K-1}) at x3 closes the argument (halo2 0.2.0
poly/multiopen.rs fold directions).

Prover and verifier MUST build their query lists in the same canonical
order (plonk/prover.py and plonk/verifier.py share the schedule).

On the native host engine (``host``) the prover holds every polynomial as
an (n, 32) canonical-bytes array and runs the folds, divisions,
evaluations, commitment and IPA natively (:func:`_multiopen_prove_native`):
the same field ops in the same order, so the same bytes; the verifier runs
its MSMs there."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..curves.host import VESTA, Point
from ..fields.host import FP
from ..poly.domain import eval_poly_coeffs
from ..poly.lagrange import lagrange_interpolate
from ..plonk.transcript import TranscriptRead, TranscriptWrite
from ..ops.msm import msm
from .ipa import Params, _create_open_proof_native, _host_commit_arr, commit, create_open_proof, verify_open_proof

P = FP.modulus


@dataclass
class Query:
    poly: list  # coefficient list (prover side)
    blind: int
    point: int
    eval: int


@dataclass
class VerifierQuery:
    name: object  # poly identity key — same grouping as the prover's id(poly)
    commitment: Point
    point: int
    eval: int


def _group(queries, key_fn):
    """-> (poly_order, per-poly {point: eval}), then point-set grouping in
    first-occurrence order."""
    poly_keys = []
    by_poly: dict = {}
    for q in queries:
        k = key_fn(q)
        if k not in by_poly:
            by_poly[k] = {"queries": [], "points": []}
            poly_keys.append(k)
        by_poly[k]["queries"].append(q)
        if q.point not in by_poly[k]["points"]:
            by_poly[k]["points"].append(q.point)

    set_order = []
    sets: dict = {}
    for k in poly_keys:
        # repr-keyed sort: any total order works (the tuple is only a set
        # key), and repr tolerates the format-describer's symbolic points
        # (("rot", "last")) alongside real int points
        pts = tuple(sorted(by_poly[k]["points"], key=repr))
        if pts not in sets:
            sets[pts] = []
            set_order.append(pts)
        sets[pts].append(k)
    return poly_keys, by_poly, set_order, sets


def _poly_sub(a: list[int], b: list[int]) -> list[int]:
    n = max(len(a), len(b))
    out = [0] * n
    for i in range(n):
        av = a[i] if i < len(a) else 0
        bv = b[i] if i < len(b) else 0
        out[i] = (av - bv) % P
    return out


def _poly_divide_linear(poly: list[int], point: int) -> list[int]:
    """Exact division by (X - point); remainder asserted zero."""
    out = [0] * (len(poly) - 1)
    rem = 0
    for i in range(len(poly) - 1, -1, -1):
        cur = (poly[i] + rem * point) % P
        if i == 0:
            assert cur == 0, "non-zero remainder in multiopen division"
        else:
            out[i - 1] = cur
            rem = cur
    return out


def _multiopen_prove_native(params: Params, transcript: TranscriptWrite, queries: list[Query], rng):
    """multiopen_prove on the native host engine: the same folds, commitment
    and opening, with every polynomial an (n, 32) canonical-bytes array
    (a PolyInts query brings its own) and pasta_axpy / pasta_div_linear /
    pasta_horner doing the work."""
    from .. import native

    which = native.which_for(P)
    x1 = transcript.squeeze_challenge()
    x2 = transcript.squeeze_challenge()
    _, by_poly, set_order, sets = _group(queries, key_fn=lambda q: id(q.poly))

    width = params.n
    arrs: dict = {}

    def poly_arr(k):
        if k not in arrs:
            poly = by_poly[k]["queries"][0].poly
            assert len(poly) <= width, "poly exceeds the SRS size"
            a = np.zeros((width, 32), np.uint8)
            pre = getattr(poly, "bytes_arr", None)
            a[: len(poly)] = pre if pre is not None else native.ints_to_bytes_arr([v % P for v in poly])
            arrs[k] = a
        return arrs[k]

    q_arrs, q_blinds, q_evals = [], [], []
    for pts in set_order:
        acc = np.zeros((width, 32), np.uint8)
        blind_acc = 0
        evals = {p: 0 for p in pts}
        for k in sets[pts]:
            info = by_poly[k]
            acc = native.axpy(which, acc, x1, poly_arr(k))
            blind_acc = (blind_acc * x1 + info["queries"][0].blind) % P
            ev_by_point = {q.point: q.eval for q in info["queries"]}
            for p in pts:
                evals[p] = (evals[p] * x1 + ev_by_point[p]) % P
        q_arrs.append(acc)
        q_blinds.append(blind_acc)
        q_evals.append(evals)

    f_acc = np.zeros((width, 32), np.uint8)
    for pts, qa, qe in zip(set_order, q_arrs, q_evals):
        r = lagrange_interpolate(list(pts), [qe[p] for p in pts])
        r_arr = np.zeros((width, 32), np.uint8)
        r_arr[: len(r)] = native.ints_to_bytes_arr([v % P for v in r])
        quotient = native.axpy(which, r_arr, P - 1, qa)  # qa - r
        for p in pts:
            assert native.div_linear(which, quotient, p) == 0, "non-zero remainder in multiopen division"
        f_acc = native.axpy(which, f_acc, x2, quotient)

    f_blind = FP.random(rng)
    transcript.write_point(_host_commit_arr(params, f_acc, f_blind))
    x3 = transcript.squeeze_challenge()

    for qa in q_arrs:
        transcript.write_scalar(native.horner(which, qa, x3))
    x4 = transcript.squeeze_challenge()

    final_acc, final_blind = f_acc, f_blind
    for qa, qb in zip(q_arrs, q_blinds):
        final_acc = native.axpy(which, final_acc, x4, qa)
        final_blind = (final_blind * x4 + qb) % P
    _create_open_proof_native(params, transcript, final_acc, final_blind, x3, rng)


def multiopen_prove(params: Params, transcript: TranscriptWrite, queries: list[Query], rng, host: bool):
    """halo2 0.2.0 structure (poly/multiopen.rs create_proof): x1 and x2
    squeezed back-to-back; ALL combinations are Horner folds in query order
    (q_poly = fold acc·x1 + poly; f = fold acc·x2 + quotient; final
    p = f then fold acc·x4 + q_i). ``host``: run it on the native host
    engine."""
    if host:
        return _multiopen_prove_native(params, transcript, queries, rng)
    x1 = transcript.squeeze_challenge()
    x2 = transcript.squeeze_challenge()
    _, by_poly, set_order, sets = _group(queries, key_fn=lambda q: id(q.poly))

    q_polys, q_blinds, q_evals = [], [], []
    for pts in set_order:
        size = max(len(by_poly[k]["queries"][0].poly) for k in sets[pts])
        poly_acc = np.zeros(size, dtype=object)
        blind_acc = 0
        evals = {p: 0 for p in pts}
        for k in sets[pts]:
            info = by_poly[k]
            poly = info["queries"][0].poly
            blind = info["queries"][0].blind
            arr = np.empty(len(poly), dtype=object)
            arr[:] = poly
            poly_acc = poly_acc * x1 % P
            poly_acc[: len(poly)] = (poly_acc[: len(poly)] + arr) % P
            blind_acc = (blind_acc * x1 + blind) % P
            ev_by_point = {q.point: q.eval for q in info["queries"]}
            for p in pts:
                evals[p] = (evals[p] * x1 + ev_by_point[p]) % P
        q_polys.append([int(v) for v in poly_acc])
        q_blinds.append(blind_acc)
        q_evals.append(evals)

    f_size = max(len(qp) for qp in q_polys)
    f_acc = np.zeros(f_size, dtype=object)
    for pts, qp, qe in zip(set_order, q_polys, q_evals):
        r = lagrange_interpolate(list(pts), [qe[p] for p in pts])
        quotient = _poly_sub(qp, r)
        for p in pts:
            quotient = _poly_divide_linear(quotient, p)
        arr = np.empty(len(quotient), dtype=object)
        arr[:] = quotient
        f_acc = f_acc * x2 % P
        f_acc[: len(quotient)] = (f_acc[: len(quotient)] + arr) % P
    f_poly = [int(v) for v in f_acc]

    f_blind = FP.random(rng)
    transcript.write_point(commit(params, f_poly, f_blind))
    x3 = transcript.squeeze_challenge()

    q_at_x3 = [eval_poly_coeffs(qp, x3) for qp in q_polys]
    for v in q_at_x3:
        transcript.write_scalar(v)
    x4 = transcript.squeeze_challenge()

    width = max(params.n, len(f_poly))
    final_acc = np.zeros(width, dtype=object)
    final_acc[: len(f_poly)] = f_poly
    final_blind = f_blind
    for qp, qb in zip(q_polys, q_blinds):
        arr = np.empty(len(qp), dtype=object)
        arr[:] = qp
        final_acc = final_acc * x4 % P
        final_acc[: len(qp)] = (final_acc[: len(qp)] + arr) % P
        final_blind = (final_blind * x4 + qb) % P
    final_poly = [int(v) for v in final_acc]

    create_open_proof(params, transcript, final_poly, final_blind, x3, rng)


def multiopen_verify(params: Params, transcript: TranscriptRead, queries: list[VerifierQuery], host: bool) -> bool:
    """Mirror of multiopen_prove's Horner folds on commitments/evals; its
    MSMs on the native host engine if ``host``."""
    x1 = transcript.squeeze_challenge()
    x2 = transcript.squeeze_challenge()
    _, by_poly, set_order, sets = _group(queries, key_fn=lambda q: q.name)

    q_commit_terms = []  # per set: list of (commitment, x1-power scalar)
    q_evals = []
    for pts in set_order:
        members = sets[pts]
        count = len(members)
        terms = []
        evals = {p: 0 for p in pts}
        for i, k in enumerate(members):
            info = by_poly[k]
            # Horner: member i of `count` carries x1^(count-1-i)
            terms.append((info["queries"][0].commitment, pow(x1, count - 1 - i, P)))
            ev_by_point = {q.point: q.eval for q in info["queries"]}
            for p in pts:
                evals[p] = (evals[p] * x1 + ev_by_point[p]) % P
        q_commit_terms.append(terms)
        q_evals.append(evals)

    f_commitment = transcript.read_point()
    x3 = transcript.squeeze_challenge()
    q_at_x3 = [transcript.read_scalar() for _ in set_order]
    x4 = transcript.squeeze_challenge()

    # f(x3) claim from revealed q evals (Horner in x2, set order)
    f_claim = 0
    for pts, qe, qv in zip(set_order, q_evals, q_at_x3):
        r = lagrange_interpolate(list(pts), [qe[p] for p in pts])
        r_at = eval_poly_coeffs(r, x3)
        denom = 1
        for p in pts:
            denom = denom * (x3 - p) % P
        f_claim = (f_claim * x2 + (qv - r_at) * FP.inv(denom)) % P

    # expected commitment and value of the final polynomial: Horner in x4
    # starting from f (final = f·x4^K + Σ q_i·x4^(K-1-i))
    k_sets = len(set_order)
    pts_scalars: list[tuple[Point, int]] = [(f_commitment, pow(x4, k_sets, P))]
    expected_value = f_claim * pow(x4, k_sets, P) % P
    for i, (terms, qv) in enumerate(zip(q_commit_terms, q_at_x3)):
        mult = pow(x4, k_sets - 1 - i, P)
        for c, s in terms:
            pts_scalars.append((c, s * mult % P))
        expected_value = (expected_value + mult * qv) % P

    acc = msm(VESTA, [c for c, _ in pts_scalars], [s for _, s in pts_scalars], params.device, host=host)
    return verify_open_proof(params, transcript, acc, x3, expected_value, host)
