"""Batch prover: B proofs under one proving key, phase by phase.

Every proof of a batch advances through the same Fiat-Shamir phase
together, and each phase's polynomial work for the whole batch runs as one
batched device pass: the commitments through
``pcs/ipa.py::commit_lagrange_many`` / ``commit_many`` (``batch_chunk``
columns per pass), the quotient through
``ops/gate_eval.py::BatchQuotientEvaluator`` (one VM program, one K1 launch
per instruction, for up to ``batch_quotient_chunk`` proofs). Host work
(witness synthesis, transcript squeezes, grand products) runs per proof in
between, and the tail (evaluations, multiopen, IPA, ``_proof_tail``) runs
per proof, on ``batch_tail_workers`` threads. ``plonk/prover.py::
create_proof`` is a batch of one.

Each proof's transcript, rng draw order and field ops are its own, so
proof i is bit-identical to ``create_proof`` with the same rng, and to the
reference's: only the scheduling of device work depends on the batch.

Engines (``engine`` argument, default ``BZ_BATCH_ENGINE``): ``device`` and
``auto`` run the device path above; ``host``, the native C++ engine of the
reference, is not ported (ROADMAP queue 1 item 5) and raises.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..config import config as _config
from ..curves.host import VESTA
from ..fields.host import FP
from ..pcs.ipa import Params, commit_lagrange_many, commit_many
from ..pcs.multiopen import Query, multiopen_prove
from ..poly.domain import eval_poly_coeffs
from .arguments import ProofSchedule, evaluate_expression, permute_lookup_inputs
from .assignment import Assignment, Layouter
from .circuit import ConstraintSystem
from .expression import ColumnType
from .keys import DELTA, ProvingKey
from .prover import _configure_cached, _grand_product_prefix, _obj_array
from .transcript import TranscriptWrite

P = FP.modulus
ENGINES = ("auto", "device", "host")
_evaluator_lock = threading.Lock()


def _batch_engine(explicit: str | None) -> str:
    """The engine a batch runs on: ``device`` for auto and device; ``host``
    raises NotImplementedError (the native engine is not ported)."""
    engine = _config().batch_engine if explicit is None else explicit
    if engine not in ENGINES:
        raise ValueError(f"batch engine must be one of {ENGINES}, got {engine!r}")
    if engine == "host":
        raise NotImplementedError(
            "batch engine 'host' is the reference's native C++ engine (csrc/pasta.cpp), "
            "which this package does not port yet (ROADMAP queue 1 item 5); use 'device' or 'auto'"
        )
    return "device"


def _get_quotient_evaluator(vk, schedule, device):
    """One batch evaluator per (verifying key, device), cached on the vk."""
    cache = vk.__dict__.setdefault("_quotient_evaluators", {})
    key = str(device)
    if key not in cache:
        with _evaluator_lock:
            if key not in cache:
                from ..ops.gate_eval import BatchQuotientEvaluator

                cache[key] = BatchQuotientEvaluator(vk, schedule, device)
    return cache[key]


class _ProofState:
    """Per-proof mutable state threaded through the phases."""


def create_proofs_batched(
    params: Params,
    pk: ProvingKey,
    circuits: list,
    instances_list: list,
    rngs: list,
    engine: str | None = None,
) -> list[bytes]:
    """Prove ``circuits[i]`` with public input ``instances_list[i]`` and
    blinding randomness ``rngs[i]``; all circuits share ``pk``. Returns the
    proof bytes in order, each bit-identical to
    ``create_proof(params, pk, circuits[i], instances_list[i], rngs[i])``."""
    assert len(circuits) == len(instances_list) == len(rngs)
    engine = _batch_engine(engine)
    if not circuits:
        return []
    cfg = _config()
    vk = pk.vk
    cs: ConstraintSystem = vk.cs
    domain = vk.domain
    n = params.n
    usable = cs.usable_rows(n)
    schedule = ProofSchedule.build(cs)
    t0 = time.time()

    def mark(name):
        nonlocal t0
        if cfg.trace_prover:
            now = time.time()
            print(f"[prover B={len(circuits)}] {name}: {now - t0:.2f}s", flush=True)
            t0 = now
        else:
            t0 = time.time()

    chunk = cfg.batch_chunk
    states = [_ProofState() for _ in circuits]
    fixed_values = pk.fixed_values
    fixed_polys = pk.fixed_polys

    # --- phase 0: transcripts + instance columns ---------------------------
    all_instance_cols: list = []
    for s, instances, rng in zip(states, instances_list, rngs):
        s.rng = rng
        s.transcript = TranscriptWrite(VESTA)
        s.transcript.common_scalar(vk.digest)
        s.instance_values = []
        for ci in range(cs.num_instance):
            vals = list(instances[ci]) if ci < len(instances) else []
            assert len(vals) <= usable
            s.instance_values.append([v % P for v in vals] + [0] * (n - len(vals)))
        all_instance_cols.extend(s.instance_values)

    polys, points = commit_lagrange_many(params, domain, all_instance_cols, [0] * len(all_instance_cols), chunk)
    off = 0
    for s in states:
        k = len(s.instance_values)
        s.instance_polys = polys[off : off + k]
        for point in points[off : off + k]:
            s.transcript.common_point(point)
        off += k
    mark("instance commit")

    # --- phase 1: witness synthesis + advice commits -----------------------
    circuit_config = _configure_cached(cs, circuits[0])
    all_advice_cols: list = []
    all_advice_blinds: list = []
    for s, circuit in zip(states, circuits):
        assignment = Assignment(cs, n)
        layouter = Layouter(assignment)
        circuit.synthesize(circuit_config, layouter)
        layouter.finalize()
        s.advice_values = []
        for col in assignment.advice:
            vals = [0 if v is None else v % P for v in col]
            for row in range(usable, n):
                vals[row] = FP.random(s.rng)
            s.advice_values.append(vals)
        s.advice_blinds = [FP.random(s.rng) for _ in s.advice_values]
        all_advice_cols.extend(s.advice_values)
        all_advice_blinds.extend(s.advice_blinds)
    mark("witness synthesis")

    polys, points = commit_lagrange_many(params, domain, all_advice_cols, all_advice_blinds, chunk)
    off = 0
    for s in states:
        k = len(s.advice_values)
        s.advice_polys = polys[off : off + k]
        for point in points[off : off + k]:
            s.transcript.write_point(point)
        off += k
        s.theta = s.transcript.squeeze_challenge()
    mark("advice commit")

    # --- phase 2: lookups compress + permute -------------------------------
    all_lookup_cols: list = []
    all_lookup_blinds: list = []
    for s in states:
        def lagrange_matrix(column, s=s):
            if column.kind == ColumnType.ADVICE:
                return _obj_array(s.advice_values[column.index])
            if column.kind == ColumnType.FIXED:
                return _obj_array(fixed_values[column.index])
            return _obj_array(s.instance_values[column.index])

        s.lookups = []
        for lk in cs.lookups:
            def eval_lagrange_expr(expr, lm=lagrange_matrix):
                return evaluate_expression(
                    cs,
                    expr,
                    cell_fn=lambda col, rot: np.roll(lm(col), -rot),
                    selector_as_fixed_fn=lambda idx: _obj_array(fixed_values[idx]),
                )

            a_comp = np.zeros(n, dtype=object)
            s_comp = np.zeros(n, dtype=object)
            for i_expr, t_expr in lk.mapping:
                a_comp = (a_comp * s.theta + eval_lagrange_expr(i_expr)) % P
                s_comp = (s_comp * s.theta + eval_lagrange_expr(t_expr)) % P
            a_act = [int(v) for v in a_comp[:usable]]
            s_act = [int(v) for v in s_comp[:usable]]
            a_perm, s_perm = permute_lookup_inputs(a_act, s_act)
            tail = [FP.random(s.rng) for _ in range(n - usable)]
            tail2 = [FP.random(s.rng) for _ in range(n - usable)]
            s.lookups.append(
                {
                    "a_compressed": [int(v) for v in a_comp],
                    "s_compressed": [int(v) for v in s_comp],
                    "a_perm": a_perm + tail,
                    "s_perm": s_perm + tail2,
                }
            )
        if s.lookups:
            all_lookup_cols.extend(v for lk in s.lookups for v in (lk["a_perm"], lk["s_perm"]))
            all_lookup_blinds.extend(FP.random(s.rng) for _ in range(2 * len(s.lookups)))
    mark("lookup permute")

    flat, points = commit_lagrange_many(params, domain, all_lookup_cols, all_lookup_blinds, chunk)
    off = 0
    for s in states:
        s.lookup_perm_polys = []
        for i in range(len(s.lookups)):
            j = off + 2 * i
            s.transcript.write_point(points[j])
            s.transcript.write_point(points[j + 1])
            s.lookup_perm_polys.append((flat[j], all_lookup_blinds[j], flat[j + 1], all_lookup_blinds[j + 1]))
        off += 2 * len(s.lookups)
        s.beta = s.transcript.squeeze_challenge()
        s.gamma = s.transcript.squeeze_challenge()
    mark("lookup commit")

    # --- phase 3: grand products + random poly -----------------------------
    perm = vk.permutation
    chunk_len = schedule.chunk_len
    chunk_cols = [perm.columns[i : i + chunk_len] for i in range(0, len(perm.columns), chunk_len)]
    chunk_sigmas = [perm.sigmas[i : i + chunk_len] for i in range(0, len(perm.sigmas), chunk_len)]
    omega = domain.omega
    w_pows = np.empty(usable, dtype=object)
    acc_w = 1
    for i in range(usable):
        w_pows[i] = acc_w
        acc_w = acc_w * omega % P

    all_z_cols: list = []
    all_z_blinds: list = []
    all_random_polys: list = []
    all_random_blinds: list = []
    for s in states:
        s.perm_z_values = []
        carry = 1  # chunks chain multiplicatively
        for cols, sigmas in zip(chunk_cols, chunk_sigmas):
            col_offsets = [perm.columns.index(c) for c in cols]
            nums = np.ones(usable, dtype=object)
            dens = np.ones(usable, dtype=object)
            for c_idx, col in enumerate(cols):
                if col.kind == ColumnType.ADVICE:
                    vals = s.advice_values[col.index]
                elif col.kind == ColumnType.FIXED:
                    vals = fixed_values[col.index]
                else:
                    vals = s.instance_values[col.index]
                v = _obj_array(vals[:usable])
                delta_beta = s.beta * pow(DELTA, col_offsets[c_idx], P) % P
                sig = _obj_array(sigmas[c_idx][:usable])
                nums = nums * ((v + delta_beta * w_pows + s.gamma) % P) % P
                dens = dens * ((v + s.beta * sig + s.gamma) % P) % P
            z = [0] * n
            z[: usable + 1] = _grand_product_prefix(nums, dens, carry)
            carry = z[usable]
            for row in range(usable + 1, n):
                z[row] = FP.random(s.rng)
            s.perm_z_values.append(z)
        s.perm_z_blinds = [FP.random(s.rng) for _ in s.perm_z_values]

        s.lookup_z_values = []
        for lk in s.lookups:
            a_c = _obj_array(lk["a_compressed"][:usable])
            s_c = _obj_array(lk["s_compressed"][:usable])
            a_p = _obj_array(lk["a_perm"][:usable])
            s_p = _obj_array(lk["s_perm"][:usable])
            nums = (a_c + s.beta) * (s_c + s.gamma) % P
            dens = (a_p + s.beta) * (s_p + s.gamma) % P
            z = [0] * n
            z[: usable + 1] = _grand_product_prefix(nums, dens, 1)
            for row in range(usable + 1, n):
                z[row] = FP.random(s.rng)
            s.lookup_z_values.append(z)
        s.lookup_z_blinds = [FP.random(s.rng) for _ in s.lookup_z_values]

        s.random_poly = [FP.random(s.rng) for _ in range(n)]
        s.random_blind = FP.random(s.rng)

        all_z_cols.extend(s.perm_z_values + s.lookup_z_values)
        all_z_blinds.extend(s.perm_z_blinds + s.lookup_z_blinds)
        all_random_polys.append(s.random_poly)
        all_random_blinds.append(s.random_blind)
    mark("grand products")

    z_polys, z_points = commit_lagrange_many(params, domain, all_z_cols, all_z_blinds, chunk)
    random_points = commit_many(params, all_random_polys, all_random_blinds, chunk)
    off = 0
    for s, random_point in zip(states, random_points):
        k = len(s.perm_z_values)
        s.perm_z_polys = z_polys[off : off + k]
        for point in z_points[off : off + k]:
            s.transcript.write_point(point)
        off += k
        k = len(s.lookup_z_values)
        s.lookup_z_polys = list(zip(z_polys[off : off + k], s.lookup_z_blinds))
        for point in z_points[off : off + k]:
            s.transcript.write_point(point)
        off += k
        s.transcript.write_point(random_point)
        s.y = s.transcript.squeeze_challenge()
    mark("z commit")

    # --- phase 4: quotients -------------------------------------------------
    def polys_by_key(s):
        out = {}
        for i, poly in enumerate(s.advice_polys):
            out[("advice", i)] = poly
        for i, poly in enumerate(fixed_polys):
            out[("fixed", i)] = poly
        for i, poly in enumerate(s.instance_polys):
            out[("instance", i)] = poly
        for i, poly in enumerate(s.perm_z_polys):
            out[("perm_z", i)] = poly
        for i, poly in enumerate(perm.sigma_polys):
            out[("sigma", i)] = poly
        for i, (a_poly, _, s_poly, _) in enumerate(s.lookup_perm_polys):
            out[("lk_a", i)] = a_poly
            out[("lk_s", i)] = s_poly
        for i, (z_poly, _) in enumerate(s.lookup_z_polys):
            out[("lk_z", i)] = z_poly
        return out

    evaluator = _get_quotient_evaluator(vk, schedule, params.device)
    qchunk = cfg.batch_quotient_chunk
    for start in range(0, len(states), qchunk):
        group = states[start : start + qchunk]
        hs = evaluator([polys_by_key(s) for s in group], [(s.theta, s.beta, s.gamma, s.y) for s in group])
        for s, h in zip(group, hs):
            s.h_coeffs = h
    mark("quotient")

    num_pieces = domain.extended_n // n
    all_h_pieces: list = []
    all_h_blinds: list = []
    for s in states:
        s.h_pieces = [s.h_coeffs[i * n : (i + 1) * n] for i in range(num_pieces)]
        s.h_blinds = [FP.random(s.rng) for _ in s.h_pieces]
        all_h_pieces.extend(s.h_pieces)
        all_h_blinds.extend(s.h_blinds)
    h_points = commit_many(params, all_h_pieces, all_h_blinds, chunk)
    off = 0
    for s in states:
        for point in h_points[off : off + num_pieces]:
            s.transcript.write_point(point)
        off += num_pieces
        s.x = s.transcript.squeeze_challenge()
    mark("h commit")

    # --- phases 5 + 6: evaluations, multiopen and IPA, per proof -----------
    workers = cfg.batch_tail_workers
    if workers > 1 and len(states) > 1:
        from concurrent.futures import ThreadPoolExecutor

        def tail(s):
            _proof_tail(params, pk, schedule, s, usable)
            return s.transcript.finalize()

        with ThreadPoolExecutor(max_workers=workers) as pool:
            proofs = list(pool.map(tail, states))
        mark("evals+multiopen+ipa")
        return proofs
    proofs = []
    for s in states:
        _proof_tail(params, pk, schedule, s, usable, mark)
        proofs.append(s.transcript.finalize())
    return proofs


def _proof_tail(params, pk, schedule, s, usable: int, mark=lambda name: None):
    """Evaluations at x, multiopen and IPA of one proof of a batch. ``s``
    holds the proof's transcript, rng, x, polynomials and blinds. The
    multiopen groups polynomials by object identity: the fixed and sigma
    polynomials are the proving key's own objects, shared by every proof,
    so a proof in a batch groups, and so writes, exactly as one alone.
    ``mark`` closes a trace span."""
    vk = pk.vk
    domain = vk.domain
    n = params.n
    x = s.x
    transcript = s.transcript
    fixed_polys = pk.fixed_polys
    sigma_polys = vk.permutation.sigma_polys

    # --- evaluations (halo2 0.2.0 write order: instance, advice, fixed,
    # vanishing random_eval, sigmas, permutation z sets, lookups) -----------
    def rot_point(rot):
        return domain.rotate_point(x, rot)

    instance_evals = {}
    for col, rot in schedule.instance_queries:
        instance_evals[(col, rot)] = eval_poly_coeffs(s.instance_polys[col], rot_point(rot))
        transcript.write_scalar(instance_evals[(col, rot)])
    advice_evals = {}
    for col, rot in schedule.advice_queries:
        advice_evals[(col, rot)] = eval_poly_coeffs(s.advice_polys[col], rot_point(rot))
        transcript.write_scalar(advice_evals[(col, rot)])
    fixed_evals = {}
    for col, rot in schedule.fixed_queries:
        fixed_evals[(col, rot)] = eval_poly_coeffs(fixed_polys[col], rot_point(rot))
        transcript.write_scalar(fixed_evals[(col, rot)])

    # vanishing argument, part 2 (halo2 vanishing/prover.rs evaluate): the h
    # pieces collapse by x^n into ONE polynomial opened at x; no h evals are
    # written — the verifier derives the expected h(x) from the identity
    xn = pow(x, n, P)
    h_acc = np.zeros(n, dtype=object)
    h_blind_acc = 0
    for piece, pblind in zip(reversed(s.h_pieces), reversed(s.h_blinds)):
        arr = np.empty(len(piece), dtype=object)
        arr[:] = piece
        h_acc = h_acc * xn % P
        h_acc[: len(piece)] = (h_acc[: len(piece)] + arr) % P
        h_blind_acc = (h_blind_acc * xn + pblind) % P
    h_collapsed = [int(v) for v in h_acc]
    h_collapsed_eval = eval_poly_coeffs(h_collapsed, x)

    random_eval = eval_poly_coeffs(s.random_poly, x)
    transcript.write_scalar(random_eval)

    sigma_evals = [eval_poly_coeffs(p, x) for p in sigma_polys]
    for ev in sigma_evals:
        transcript.write_scalar(ev)
    x_next = rot_point(1)
    x_last_rot = domain.rotate_point(x, usable)
    perm_z_evals = []
    for c, poly in enumerate(s.perm_z_polys):
        z_x = eval_poly_coeffs(poly, x)
        z_wx = eval_poly_coeffs(poly, x_next)
        transcript.write_scalar(z_x)
        transcript.write_scalar(z_wx)
        entry = {"z": z_x, "z_next": z_wx}
        if c < len(s.perm_z_polys) - 1:
            entry["last"] = eval_poly_coeffs(poly, x_last_rot)
        perm_z_evals.append(entry)
    # halo2 permutation/prover.rs: the ω^(-(b+1))x evals come AFTER all the
    # (z@x, z@ωx) pairs, in REVERSE set order skipping the final set
    for c in range(len(s.perm_z_polys) - 2, -1, -1):
        transcript.write_scalar(perm_z_evals[c]["last"])

    x_prev = rot_point(-1)
    lookup_evals = []
    for (z_poly, _), (a_poly, _, s_poly, _) in zip(s.lookup_z_polys, s.lookup_perm_polys):
        ev = {
            "z": eval_poly_coeffs(z_poly, x),
            "z_next": eval_poly_coeffs(z_poly, x_next),
            "a_perm": eval_poly_coeffs(a_poly, x),
            "a_perm_prev": eval_poly_coeffs(a_poly, x_prev),
            "s_perm": eval_poly_coeffs(s_poly, x),
        }
        for key in ("z", "z_next", "a_perm", "a_perm_prev", "s_perm"):
            transcript.write_scalar(ev[key])
        lookup_evals.append(ev)

    mark("evaluations")
    # --- multiopen + IPA (halo2 prover.rs open order: instance, advice,
    # permutation sets, lookups, then fixed, sigmas, vanishing h+random) ----
    queries: list[Query] = []
    for col, rot in schedule.instance_queries:
        queries.append(Query(s.instance_polys[col], 0, rot_point(rot), instance_evals[(col, rot)]))
    for col, rot in schedule.advice_queries:
        queries.append(Query(s.advice_polys[col], s.advice_blinds[col], rot_point(rot), advice_evals[(col, rot)]))
    for c, poly in enumerate(s.perm_z_polys):
        queries.append(Query(poly, s.perm_z_blinds[c], x, perm_z_evals[c]["z"]))
        queries.append(Query(poly, s.perm_z_blinds[c], x_next, perm_z_evals[c]["z_next"]))
    for c in range(len(s.perm_z_polys) - 2, -1, -1):
        queries.append(Query(s.perm_z_polys[c], s.perm_z_blinds[c], x_last_rot, perm_z_evals[c]["last"]))
    # lookup open order (halo2 lookup/prover.rs): z@x, a'@x, s'@x, a'@ω⁻¹x, z@ωx
    for (z_poly, z_blind), (a_poly, a_blind, s_poly, s_blind), ev in zip(
        s.lookup_z_polys, s.lookup_perm_polys, lookup_evals
    ):
        queries.append(Query(z_poly, z_blind, x, ev["z"]))
        queries.append(Query(a_poly, a_blind, x, ev["a_perm"]))
        queries.append(Query(s_poly, s_blind, x, ev["s_perm"]))
        queries.append(Query(a_poly, a_blind, x_prev, ev["a_perm_prev"]))
        queries.append(Query(z_poly, z_blind, x_next, ev["z_next"]))
    for col, rot in schedule.fixed_queries:
        queries.append(Query(fixed_polys[col], 0, rot_point(rot), fixed_evals[(col, rot)]))
    for j, poly in enumerate(sigma_polys):
        queries.append(Query(poly, 0, x, sigma_evals[j]))
    queries.append(Query(h_collapsed, h_blind_acc, x, h_collapsed_eval))
    queries.append(Query(s.random_poly, s.random_blind, x, random_eval))

    mark("query build")
    multiopen_prove(params, transcript, queries, s.rng)
    mark("multiopen+ipa")
