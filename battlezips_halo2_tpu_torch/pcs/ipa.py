"""Inner-product-argument polynomial commitment scheme over Vesta.

Framework analog of ``halo2_proofs::poly::commitment``: deterministic SRS,
blinded Pedersen vector commitments (every commitment is a device MSM over
[G | W]), and the log-n inner-product opening argument in halo2 0.2.0's
exact shape (synthetic-blinding S commitment, xi/z challenges, asymmetric
folds; see create_open_proof / verify_open_proof for the round equations).

SRS derivation follows halo2 0.2.0: hash_to_curve("Halo2-Parameters") on
Vesta through the SSWU map of curves/hashtocurve.py.

``Params`` carries the device every commitment runs on; its G | W point
table is uploaded once. On the native host engine (an explicit ``engine``,
or ops/engine.py's routing of the domain) commitments are the native
Pippenger over a cached G | W buffer; the prover's opening there is
:func:`_create_open_proof_native`, with every vector as (n, 32) bytes, and
the verifier's (``verify_open_proof``'s ``host``) takes the native
s-vector and MSMs.

The SRS persists in the port's artifact store (artifacts.py):
``Params.save`` / ``load`` write and read k, G, U and W with both
coordinates of every point, and :func:`cached_params` reads the file once a
process (or derives it and writes it) and binds the points to each device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .. import artifacts
from ..curves import limb as C
from ..curves.host import VESTA, Point
from ..fields.host import FP
from ..fields.limb import FieldSpec, NLIMBS, ints_to_limbs, limbs_to_ints
from ..ops.cuda import resolve_device
from ..ops.dispatch import device_call
from ..ops.engine import use_host_engine
from ..ops.msm import host_msm, msm, msm_many_table
from ..plonk.transcript import TranscriptRead, TranscriptWrite
from ..poly.polyints import PolyInts

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

    # --- persistence (the artifact store, artifacts.py) -------------------
    def save(self, path) -> None:
        """Write k, G, U and W (both coordinates of every point, hex), and
        nothing of the device: the SRS is bound to a device at load."""
        data = {"k": self.k, "g": [_point_hex(p) for p in self.g], "u": _point_hex(self.u), "w": _point_hex(self.w)}
        artifacts.write_atomic(Path(path), json.dumps(data).encode())

    @staticmethod
    def load(path, device=None) -> "Params":
        """The SRS of a file written by :meth:`save`, on ``device``. Raises
        ValueError unless G holds 2^k points and every point is on Vesta.
        The file holds both coordinates, so a load decompresses nothing."""
        dev = resolve_device(device)
        data = json.loads(Path(path).read_text())
        k = int(data["k"])
        g = [_point_from_hex(h) for h in data["g"]]
        if len(g) != 1 << k:
            raise ValueError(f"{path}: {len(g)} G points for k = {k}")
        return Params(k, g, _point_from_hex(data["u"]), _point_from_hex(data["w"]), dev)

    def gw_table(self) -> torch.Tensor:
        """(n + 1, 2, 8) device table of [G | W] (curves/limb.py::affine_table)."""
        if self._gw_table is None:
            self._gw_table = C.affine_table(VESTA_BASE, self.g + [self.w], self.device)
        return self._gw_table

    def g_table(self) -> torch.Tensor:
        return self.gw_table()[: self.n]


def _point_hex(p: Point) -> list:
    return [hex(p[0]), hex(p[1])]


def _point_from_hex(xy: list) -> Point:
    q = VESTA.base.modulus
    x, y = int(xy[0], 16), int(xy[1], 16)
    if not (0 <= x < q and 0 <= y < q and VESTA.is_on_curve((x, y))):
        raise ValueError(f"({xy[0]}, {xy[1]}) is not a Vesta point")
    return (x, y)


SRS_SCHEMA = 1  # the file's layout: hex (x, y) of every point


def cached_params(k: int, device=None) -> Params:
    """The hash-to-curve SRS for 2^k rows on ``device``, from the artifact
    store: the file's points are read once a process (or derived by
    :meth:`Params.new` and written) and bound to each device asked for."""
    dev = resolve_device(device)
    path = artifacts.directory() / f"srs_h2c_k{k}_xy_v{SRS_SCHEMA}.json"

    def load(p):
        params = Params.load(p, "cpu")
        if params.k != k:
            raise ValueError(f"{p}: k = {params.k}, expected {k}")
        return params

    host = artifacts.cached(path, load, lambda: Params.new(k, "cpu"), Params.save)
    return Params(k, host.g, host.u, host.w, dev)


def _native_buffer(params: Params, name: str, points) -> bytes:
    """A native MSM point buffer of the SRS, cached on ``params``: the
    marshalling of 2^k points would cost more than the MSM."""
    cache = params.__dict__.setdefault("_native_buffers", {})
    if name not in cache:
        from .. import native

        cache[name] = native.points_buffer(points())
    return cache[name]


def _params_pbuf(params: Params) -> bytes:
    """The [G | W] buffer of the native commitments."""
    return _native_buffer(params, "gw", lambda: params.g + [params.w])


def _host_commit_arr(params: Params, coeffs, blind: int) -> Point:
    """<coeffs, G> + [blind] W on the native host engine for an (<= n, 32)
    canonical-bytes coefficient array."""
    from .. import native

    assert coeffs.shape[0] <= params.n, "polynomial longer than the SRS"
    sc = np.zeros((params.n + 1, 32), np.uint8)
    sc[: coeffs.shape[0]] = coeffs
    sc[params.n] = np.frombuffer((blind % P).to_bytes(32, "little"), dtype=np.uint8)
    return native.msm_buf_scalars(native.which_for(VESTA.base.modulus), _params_pbuf(params), sc)


def _host_commit_many(params: Params, polys: list, blinds: list) -> list[Point]:
    from .. import native

    points = []
    for poly, blind in zip(polys, blinds):
        pre = getattr(poly, "bytes_arr", None)
        arr = pre if pre is not None else native.ints_to_bytes_arr([v % P for v in poly])
        points.append(_host_commit_arr(params, arr, blind))
    return points


def _engine_host(engine: str | None, n: int) -> bool:
    """Whether a commitment runs on the native host engine: ``engine``
    "host" / "device", or None to let ops/engine.py route size n."""
    if engine is None:
        return use_host_engine(n)
    if engine not in ("host", "device"):
        raise ValueError(f"engine must be 'host' or 'device', got {engine!r}")
    return engine == "host"


def _active_mesh():
    """The active mesh of parallel/context.py if it has several shards,
    else None. Under it every commitment is the sharded MSM, ahead of the
    engine routing, as in the reference."""
    from ..parallel.context import get_mesh, mesh_is_active

    return get_mesh() if mesh_is_active() else None


def _gw_shards(params: Params, mesh):
    """The [G | W] table cut over ``mesh`` (parallel/msm.py::shard_table),
    cached on ``params`` per mesh key: cut once, not per commitment."""
    from ..parallel.msm import shard_table

    cache = params.__dict__.setdefault("_mesh_tables", {})
    if mesh.key not in cache:
        cache[mesh.key] = shard_table(VESTA, params.gw_table(), mesh)
    return cache[mesh.key]


def _commit_limbs(params: Params, coeffs: torch.Tensor, blinds: list) -> list[Point]:
    """<coeffs_i, G> + [blind_i] W for a (B, <= n, 8) canonical coefficient
    tensor: one batched device MSM over [G | W], or under an active mesh
    the sharded MSM (parallel/msm.py)."""
    b = coeffs.shape[0]
    scalars = torch.zeros(b, params.n + 1, NLIMBS, dtype=torch.int32, device=params.device)
    scalars[:, : coeffs.shape[1]] = coeffs
    scalars[:, params.n] = ints_to_limbs([v % P for v in blinds], params.device)
    mesh = _active_mesh()
    if mesh is not None:
        from ..parallel.msm import sharded_msm_many_table

        return sharded_msm_many_table(VESTA, _gw_shards(params, mesh), scalars, mesh)
    return msm_many_table(VESTA, params.gw_table(), scalars)


def _groups(count: int, chunk: int | None):
    """[start, stop) spans of at most ``chunk`` items (None: one span)."""
    step = count if chunk is None else chunk
    if step < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return [(i, min(i + step, count)) for i in range(0, count, step)]


def commit_many(params: Params, polys: list, blinds: list, chunk: int | None = None,
                engine: str | None = None) -> list[Point]:
    """Commit a batch of coefficient polynomials (each <= n long), ``chunk``
    of them per batched device MSM (None: all at once), or one native MSM
    each on the host engine (``engine``: "host" / "device", None routes by
    ops/engine.py). An active mesh takes them first: sharded device MSMs."""
    assert len(polys) == len(blinds)
    if not polys:
        return []
    assert all(len(p) <= params.n for p in polys)
    if _active_mesh() is None and _engine_host(engine, params.n):
        return _host_commit_many(params, polys, blinds)
    points = []
    for a, b in _groups(len(polys), chunk):
        points += device_call(_commit_group, params, polys[a:b], blinds[a:b], what="commit_many")
    return points


def _commit_group(params: Params, polys: list, blinds: list) -> list[Point]:
    """One device pass of commit_many (a pure function of its inputs, run
    again while the card is busy)."""
    flat = []
    for p in polys:
        flat += [v % P for v in p] + [0] * (params.n - len(p))
    coeffs = ints_to_limbs(flat, params.device).reshape(len(polys), params.n, NLIMBS)
    return _commit_limbs(params, coeffs, blinds)


def commit(params: Params, coeffs: list[int], blind: int) -> Point:
    """<coeffs, G> + [blind] W."""
    return commit_many(params, [coeffs], [blind])[0]


def commit_lagrange_many(params: Params, domain, values_list: list, blinds: list, chunk: int | None = None,
                         engine: str | None = None):
    """Lagrange columns -> (coefficient polys, commitments): per group of
    ``chunk`` columns (None: all at once) the iNTT and the commitment MSMs
    run on the device in one pass, and the coefficients come back to the
    host once. On the native host engine (``engine`` as in commit_many)
    the batch iNTT feeds the native Pippenger in bytes, and the polys are
    PolyInts. An active mesh takes them first: the sharded iNTT
    (poly/transforms.py) and the sharded MSMs on the device."""
    assert len(values_list) == len(blinds)
    if not values_list:
        return [], []
    n = domain.n
    assert all(len(v) == n for v in values_list)
    if _active_mesh() is None and _engine_host(engine, n):
        from .. import native

        which = native.which_for(P)
        data = np.zeros((len(values_list), n, 32), np.uint8)
        for i, col in enumerate(values_list):
            data[i] = native.ints_to_bytes_arr([v % P for v in col])
        native.ntt_batch(which, data, pow(domain.omega, -1, P))
        native.scale_batch(which, data, 1, pow(n, -1, P))
        points = [_host_commit_arr(params, row, blind) for row, blind in zip(data, blinds)]
        return [PolyInts.wrap(native.bytes_arr_to_ints(row), row) for row in data], points
    polys, points = [], []
    for a, b in _groups(len(values_list), chunk):
        group_polys, group_points = device_call(_commit_lagrange_group, params, domain, values_list[a:b],
                                                blinds[a:b], what="commit_lagrange_many")
        polys += group_polys
        points += group_points
    return polys, points


def _commit_lagrange_group(params: Params, domain, values_list: list, blinds: list) -> tuple[list, list]:
    """One device pass of commit_lagrange_many (a pure function of its
    inputs, run again while the card is busy): the iNTT and the commitment
    MSMs of a group of columns."""
    from ..poly.transforms import lagrange_to_coeff_limbs

    n = domain.n
    flat = [x % P for v in values_list for x in v]
    vals = ints_to_limbs(flat, params.device).reshape(len(values_list), n, NLIMBS)
    coeffs = lagrange_to_coeff_limbs(domain, vals)
    ints = limbs_to_ints(coeffs)
    return [ints[i : i + n] for i in range(0, len(ints), n)], _commit_limbs(params, coeffs, blinds)


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


def commit_lagrange_sparse(params: Params, domain, values: list, host: bool) -> Point:
    """Commitment of a Lagrange-basis column with blind 0, as
    sum_{v_i != 0} [v_i] G_lag_i: the same group element as
    commit(lagrange_to_coeff(values), 0), its MSM on the native host engine
    if ``host``. Callers gate on a small nonzero count."""
    points, scalars = [], []
    for i, v in enumerate(values):
        if v % P:
            points.append(lagrange_basis_commitment(params, domain, i))
            scalars.append(v % P)
    if not points:
        return None
    return msm(VESTA, points, scalars, params.device, host=host)


def _create_open_proof_native(params: Params, transcript: TranscriptWrite, coeffs_arr, blind: int, x: int, rng):
    """create_open_proof on the native host engine: the same rounds, rng
    draws and transcript, with the polynomial, b and the G coefficients
    held as (n, 32) canonical-bytes arrays and every vector op, MSM
    included, native. ``coeffs_arr``: the (<= n, 32) polynomial."""
    from .. import native

    m = P
    n = params.n
    which = native.which_for(m)
    which_pt = native.which_for(VESTA.base.modulus)
    gbuf = _native_buffer(params, "g", lambda: params.g)

    def row_int(arr, i):
        return int.from_bytes(arr[i].tobytes(), "little")

    def set_row(arr, i, v):
        arr[i] = np.frombuffer((v % m).to_bytes(32, "little"), dtype=np.uint8)

    p_prime = np.zeros((n, 32), np.uint8)
    p_prime[: coeffs_arr.shape[0]] = coeffs_arr[:n]
    b = np.zeros((1, n, 32), np.uint8)  # (1, x, x^2, ...): ones scaled by powers of x
    b[:, :, 0] = 1
    native.scale_batch(which, b, x, 1)
    b = b[0]

    s_ints = [FP.random(rng) for _ in range(n)]
    s_arr = native.ints_to_bytes_arr(s_ints)
    set_row(s_arr, 0, s_ints[0] - native.horner(which, s_arr, x))
    s_blind = FP.random(rng)
    transcript.write_point(_host_commit_arr(params, s_arr, s_blind))

    xi = transcript.squeeze_challenge()
    z = transcript.squeeze_challenge()

    p_prime = native.axpy(which, s_arr, xi, p_prime)  # xi S + P
    v = native.inner(which, p_prime, b)  # p'(x) before the shift
    set_row(p_prime, 0, row_int(p_prime, 0) - v)
    f = (blind + xi * s_blind) % m

    c_coeff = np.zeros((n, 32), np.uint8)
    c_coeff[:, 0] = 1
    zeros = np.zeros((n, 32), np.uint8)
    pos = np.arange(n)
    length = n
    while length > 1:
        half = length // 2
        p_lo, p_hi = p_prime[:half], p_prime[half:length]
        b_lo, b_hi = b[:half], b[half:length]

        l_rand = FP.random(rng)
        r_rand = FP.random(rng)
        value_l = native.inner(which, p_hi, b_lo)
        value_r = native.inner(which, p_lo, b_hi)

        hi_mask = pos >= half
        v_l = native.mul_vec(which, c_coeff, p_prime[np.where(~hi_mask, pos + half, 0)])
        v_r = native.mul_vec(which, c_coeff, p_prime[np.where(hi_mask, pos - half, 0)])
        v_l[hi_mask] = 0
        v_r[~hi_mask] = 0
        base_l = native.msm_buf_scalars(which_pt, gbuf, v_l)
        base_r = native.msm_buf_scalars(which_pt, gbuf, v_r)
        uw = [params.u, params.w]
        transcript.write_point(host_msm(VESTA, [base_l] + uw, [1, value_l * z % m, l_rand]))
        transcript.write_point(host_msm(VESTA, [base_r] + uw, [1, value_r * z % m, r_rand]))
        u = transcript.squeeze_challenge_nonzero()
        u_inv = FP.inv(u)

        p_prime = native.axpy(which, p_hi, u_inv, p_lo)
        b = native.axpy(which, b_hi, u, b_lo)
        c_coeff = np.where(hi_mask[:, None], native.axpy(which, c_coeff, u, zeros), c_coeff)
        pos = np.where(hi_mask, pos - half, pos)
        f = (f + u_inv * l_rand + u * r_rand) % m
        length = half

    transcript.write_scalar(row_int(p_prime, 0))
    transcript.write_scalar(f)


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
    (c = accumulated u-powers, pos = current fold position). This is the
    device engine's opening; the native host engine's is
    :func:`_create_open_proof_native`."""
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
    host: bool,
) -> bool:
    """Verify an opening; one n-point MSM for G_final plus O(log n) point
    terms, on the device, or with the s-vector and both MSMs on the native
    host engine if ``host``.

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

    if host:
        from .. import native

        sc = np.empty((n + 2, 32), np.uint8)
        sc[:n] = native.ipa_s_vector(native.which_for(m), us, a0, n)
        sc[n:] = native.ints_to_bytes_arr([a0 * b_final % m * z % m, f_final % m])
        guw = _native_buffer(params, "guw", lambda: params.g + [params.u, params.w])
        lhs = native.msm_buf_scalars(native.which_for(VESTA.base.modulus), guw, sc)
    else:
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
    rhs = msm(VESTA, rhs_pts, rhs_scalars, params.device, host=host)
    return lhs == rhs
