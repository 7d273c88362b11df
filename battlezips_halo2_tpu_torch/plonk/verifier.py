"""The PLONK verifier.

Framework analog of ``halo2_proofs::plonk::verify_proof`` + SingleVerifier
(SURVEY.md §2.2 "Verifier"): transcript replay, instance commitment
recomputation, the gate/permutation/lookup identity check at the challenge
point, and the multiopen + IPA verification (MSM-dominated). The engine of
the MSMs is decided once per proof and passed down.
"""

from __future__ import annotations

from .. import native
from ..config import config as _config
from ..curves.host import VESTA
from ..fields.host import FP
from ..ops.msm import msm
from ..pcs.ipa import Params, commit, commit_lagrange_sparse
from ..pcs.multiopen import VerifierQuery, multiopen_verify
from ..poly.domain import eval_poly_coeffs
from ..poly.transforms import batch_lagrange_to_coeff
from .arguments import ProofSchedule, evaluate_expression, lookup_terms, permutation_terms
from .expression import ColumnType
from .keys import VerifyingKey
from .transcript import TranscriptError, TranscriptRead

P = FP.modulus


def verify_proof(params: Params, vk: VerifyingKey, proof: bytes, instances: list[list[int]]) -> bool:
    """Returns False (never raises) on malformed proof bytes: truncated
    transcripts, non-canonical scalar reprs, and off-curve point encodings
    all raise TranscriptError from the decode layer, which is the analog of
    halo2's Err(Error::Transcript) from verify_proof — an invalid proof,
    not a caller error (src/wasm/circuit_wasm.rs:88-112 maps it to false).
    Any OTHER exception (including plain ValueError) propagates: an
    internal bug must surface as an error, not read as an invalid proof
    (ADVICE r3)."""
    try:
        return _verify_proof(params, vk, proof, instances)
    except TranscriptError as e:
        if _config().trace_verifier:
            print(f"[verify] rejected: {e}")
        return False


def _verify_proof(params: Params, vk: VerifyingKey, proof: bytes, instances: list[list[int]]) -> bool:
    cs = vk.cs
    domain = vk.domain
    n = params.n
    usable = cs.usable_rows(n)
    schedule = ProofSchedule.build(cs)
    transcript = TranscriptRead(VESTA, proof)
    transcript.common_scalar(vk.digest)
    # the small MSMs and the IPA check run on the native host engine wherever
    # BZ_PROOF_ENGINE selects it (auto, host), at any size, as the reference's do
    host = native.enabled()

    # --- instance commitments ----------------------------------------------
    instance_values = []
    for ci in range(cs.num_instance):
        vals = list(instances[ci]) if ci < len(instances) else []
        if len(vals) > usable:
            return False
        instance_values.append([v % P for v in vals] + [0] * (n - len(vals)))
    # sparse fast path: instance columns carry a handful of public values
    # (board: 2, shot: 4) — commit each as nnz Lagrange-basis scalar-muls
    # (same group element as the iNTT+dense-MSM path, pcs/ipa.py
    # commit_lagrange_sparse) instead of two dense n-point MSMs per verify
    instance_commitments = []
    for vals in instance_values:
        nnz = sum(1 for v in vals if v % P)
        if nnz <= 16:
            instance_commitments.append(commit_lagrange_sparse(params, domain, vals, host))
        else:
            poly = batch_lagrange_to_coeff(domain, [vals], params.device)[0]
            instance_commitments.append(commit(params, poly, 0))
    for c in instance_commitments:
        transcript.common_point(c)

    advice_commitments = [transcript.read_point() for _ in range(cs.num_advice)]
    theta = transcript.squeeze_challenge()
    lookup_perm_commitments = [
        (transcript.read_point(), transcript.read_point()) for _ in cs.lookups
    ]
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()
    perm_z_commitments = [transcript.read_point() for _ in range(schedule.num_perm_chunks)]
    lookup_z_commitments = [transcript.read_point() for _ in cs.lookups]
    random_commitment = transcript.read_point()
    y = transcript.squeeze_challenge()
    num_pieces = domain.extended_n // n
    h_commitments = [transcript.read_point() for _ in range(num_pieces)]
    x = transcript.squeeze_challenge()

    # --- evaluations (halo2 0.2.0 read order) -------------------------------
    instance_evals = {q: transcript.read_scalar() for q in schedule.instance_queries}
    advice_evals = {q: transcript.read_scalar() for q in schedule.advice_queries}
    fixed_evals = {q: transcript.read_scalar() for q in schedule.fixed_queries}
    random_eval = transcript.read_scalar()
    sigma_evals = [transcript.read_scalar() for _ in vk.permutation.sigma_polys]
    perm_z_evals = []
    for c in range(schedule.num_perm_chunks):
        perm_z_evals.append({"z": transcript.read_scalar(), "z_next": transcript.read_scalar()})
    for c in range(schedule.num_perm_chunks - 2, -1, -1):
        perm_z_evals[c]["last"] = transcript.read_scalar()
    lookup_evals = []
    for _ in cs.lookups:
        lookup_evals.append(
            {
                "z": transcript.read_scalar(),
                "z_next": transcript.read_scalar(),
                "a_perm": transcript.read_scalar(),
                "a_perm_prev": transcript.read_scalar(),
                "s_perm": transcript.read_scalar(),
            }
        )

    # --- constraint identity at x ------------------------------------------
    def cell_fn(column, rot):
        if column.kind == ColumnType.ADVICE:
            return advice_evals[(column.index, rot)]
        if column.kind == ColumnType.FIXED:
            return fixed_evals[(column.index, rot)]
        raise ValueError("instance columns may not appear in gates")

    def fixed_fn(idx):
        return fixed_evals[(idx, 0)]

    terms = []
    for gate in cs.gates:
        for _, poly in gate.constraints:
            terms.append(evaluate_expression(cs, poly, cell_fn, fixed_fn))

    l0 = domain.eval_lagrange(0, x)
    llast = domain.eval_lagrange(usable, x)
    lblind = 0
    for i in range(usable + 1, n):
        lblind = (lblind + domain.eval_lagrange(i, x)) % P
    lactive = (1 - llast - lblind) % P

    perm = vk.permutation
    chunk_len = schedule.chunk_len
    chunk_cols = [perm.columns[i : i + chunk_len] for i in range(0, len(perm.columns), chunk_len)]
    chunks_data = []
    for c, cols in enumerate(chunk_cols):
        entry = {
            "z": perm_z_evals[c]["z"],
            "z_next": perm_z_evals[c]["z_next"],
            "prev_last": perm_z_evals[c - 1]["last"] if c > 0 else None,
            "cols": [],
        }
        for col in cols:
            j = perm.columns.index(col)
            if col.kind == ColumnType.ADVICE:
                v = advice_evals[(col.index, 0)]
            elif col.kind == ColumnType.FIXED:
                v = fixed_evals[(col.index, 0)]
            else:
                v = instance_evals[(col.index, 0)]
            entry["cols"].append((v, sigma_evals[j], j))
        chunks_data.append(entry)
    if chunks_data:
        terms += permutation_terms(chunks_data, l0, llast, lactive, beta, gamma, x)

    for li, lk_def in enumerate(cs.lookups):
        a_comp = 0
        s_comp = 0
        for i_expr, t_expr in lk_def.mapping:
            a_comp = (a_comp * theta + evaluate_expression(cs, i_expr, cell_fn, fixed_fn)) % P
            s_comp = (s_comp * theta + evaluate_expression(cs, t_expr, cell_fn, fixed_fn)) % P
        lk_data = dict(lookup_evals[li])
        lk_data["a_compressed"] = a_comp
        lk_data["s_compressed"] = s_comp
        terms += lookup_terms(lk_data, l0, llast, lactive, beta, gamma)

    agg = 0
    for term in terms:
        agg = (agg * y + term) % P
    # vanishing argument (halo2 0.2.0 vanishing/verifier.rs): the expected
    # h(x) is DERIVED from the identity and bound through the multiopen
    # query on the x^n-collapsed h commitment — there is no separate
    # identity-at-x equality to check early
    xn = pow(x, n, P)
    expected_h_eval = agg * FP.inv((xn - 1) % P) % P
    xni = [1] * len(h_commitments)
    for i in range(1, len(h_commitments)):
        xni[i] = xni[i - 1] * xn % P
    h_collapsed_commitment = msm(VESTA, h_commitments, xni, params.device, host=host)
    if _config().trace_verifier:
        print(f"[verify] expected h(x) = {hex(expected_h_eval)} (identity failures surface as multiopen failures)", flush=True)

    # --- multiopen (halo2 verifier.rs query order: instance, advice,
    # permutation sets, lookups, fixed, sigmas, vanishing h+random) ----------
    def rot_point(rot):
        return domain.rotate_point(x, rot)

    x_next = rot_point(1)
    x_prev = rot_point(-1)
    x_last_rot = domain.rotate_point(x, usable)

    queries: list[VerifierQuery] = []
    for col, rot in schedule.instance_queries:
        queries.append(VerifierQuery(("instance", col), instance_commitments[col], rot_point(rot), instance_evals[(col, rot)]))
    for col, rot in schedule.advice_queries:
        queries.append(VerifierQuery(("advice", col), advice_commitments[col], rot_point(rot), advice_evals[(col, rot)]))
    for c_idx, c in enumerate(perm_z_commitments):
        queries.append(VerifierQuery(("perm_z", c_idx), c, x, perm_z_evals[c_idx]["z"]))
        queries.append(VerifierQuery(("perm_z", c_idx), c, x_next, perm_z_evals[c_idx]["z_next"]))
    for c_idx in range(schedule.num_perm_chunks - 2, -1, -1):
        queries.append(
            VerifierQuery(("perm_z", c_idx), perm_z_commitments[c_idx], x_last_rot, perm_z_evals[c_idx]["last"])
        )
    for li in range(len(cs.lookups)):
        zc = lookup_z_commitments[li]
        ac, sc = lookup_perm_commitments[li]
        ev = lookup_evals[li]
        queries.append(VerifierQuery(("lk_z", li), zc, x, ev["z"]))
        queries.append(VerifierQuery(("lk_a", li), ac, x, ev["a_perm"]))
        queries.append(VerifierQuery(("lk_s", li), sc, x, ev["s_perm"]))
        queries.append(VerifierQuery(("lk_a", li), ac, x_prev, ev["a_perm_prev"]))
        queries.append(VerifierQuery(("lk_z", li), zc, x_next, ev["z_next"]))
    for col, rot in schedule.fixed_queries:
        queries.append(VerifierQuery(("fixed", col), vk.fixed_commitments[col], rot_point(rot), fixed_evals[(col, rot)]))
    for j, c in enumerate(vk.permutation.sigma_commitments):
        queries.append(VerifierQuery(("sigma", j), c, x, sigma_evals[j]))
    queries.append(VerifierQuery(("h",), h_collapsed_commitment, x, expected_h_eval))
    queries.append(VerifierQuery(("random",), random_commitment, x, random_eval))

    if not multiopen_verify(params, transcript, queries, host):
        if _config().trace_verifier:
            print("[verify] FAIL: multiopen/IPA opening", flush=True)
        return False
    transcript.assert_consumed()
    return True
