"""Port MSM (ops/msm.py: digits, kernels K2 / K7 / K3 / K6 through their
plain versions on the CPU, the host window fold) against the JAX package's
host Pippenger (Curve.pippenger), its ``msm`` and its digit extraction, in
the default and the row-layout (BZ_ROW_MSM) configuration; the window
aggregation (K3's ``window_sums`` and K6's ``window_sums_planes``) against
the host group law, and K6's against the JAX package's running sums.
Exact comparisons (tolerance 0), on affine points where the order of
additions may differ."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from battlezips_halo2_tpu.curves import limb as JC
from battlezips_halo2_tpu.curves.host import VESTA as REF_VESTA
from battlezips_halo2_tpu.fields import limb as JL
from battlezips_halo2_tpu.ops import msm as JM
from battlezips_halo2_tpu_torch.curves.host import PALLAS, VESTA
from battlezips_halo2_tpu_torch.fields.limb import ints_to_limbs, limbs_to_ints
from battlezips_halo2_tpu_torch.ops import msm as M
from test_torch_inputs import bucket_rows, host_window_sum


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(curve, n: int, seed: int) -> list:
    rng = random.Random(seed)
    step = curve.mul(curve.generator, rng.randrange(1, curve.scalar.modulus))
    pts = [curve.mul(curve.generator, rng.randrange(1, curve.scalar.modulus))]
    for _ in range(n - 1):
        pts.append(curve.add(pts[-1], step))
    return pts


def _scalars(curve, n: int, seed: int) -> list:
    rng = random.Random(seed)
    q = curve.scalar.modulus
    s = [rng.randrange(q) for _ in range(n)]
    s[:3] = [0, 1, q - 1]
    return s


@pytest.mark.parametrize("n,signed", [(64, False), (64, True), (256, False), (256, True)])
def test_msm_matches_pippenger_and_jax(n, signed):
    pts = _points(VESTA, n, n)
    pts[5] = None  # an identity point in the table
    scalars = [_scalars(VESTA, n, n + 1 + i) for i in range(2 if n < 256 else 1)]
    c = 6 if signed else M.auto_window(n)[0]
    got = M.msm_many(VESTA, pts, scalars, "cpu", c=c, signed=signed)
    assert got == [REF_VESTA.pippenger(pts, s) for s in scalars]
    assert got == [JM.msm(REF_VESTA, pts, s) for s in scalars]


def test_pallas_msm_and_small_complete_path():
    """Pallas points (coordinates in Fp), and an MSM below COMPLETE_BELOW,
    which runs the complete law (K7) directly."""
    pts = _points(PALLAS, 40, 3)
    scalars = _scalars(PALLAS, 40, 4)
    assert M.msm(PALLAS, pts, scalars, "cpu") == PALLAS.msm(pts, scalars)
    assert M.msm(PALLAS, pts[:3], scalars[:3], "cpu") == PALLAS.msm(pts[:3], scalars[:3])


def test_collision_redoes_with_complete_law():
    """Equal points with equal digits meet in one bucket: the incomplete law
    (K2) flags P == Q and the batch is redone with the complete law (K7)."""
    spec = M.FieldSpec.make(VESTA.base.modulus)
    p = VESTA.mul(VESTA.generator, 12345)
    pts = [p] * M.COMPLETE_BELOW
    scalars = [3] * len(pts)
    table = M.C.affine_table(spec, pts, "cpu")
    _, collision = M.msm_wsums(spec, table, ints_to_limbs(scalars, "cpu").view(1, -1, 8), 4, False)
    assert collision
    assert M.msm(VESTA, pts, scalars, "cpu") == VESTA.mul(p, 3 * len(pts))


@pytest.mark.parametrize("c", [4, 8, 13])
def test_digits_match_jax(c):
    q = VESTA.scalar.modulus
    scalars = _scalars(VESTA, 40, c)
    limbs = ints_to_limbs(scalars, "cpu").view(1, 40, 8)
    unsigned = M.unsigned_digits(limbs, c)[0].numpy()
    assert (unsigned == JM.scalars_to_digits(scalars, c)).all()
    signed = M.signed_digits(limbs, c)[0].numpy()
    assert signed.shape[0] == M.signed_window_count(c) == JM.signed_window_count(c)
    assert (signed == JM.scalars_to_signed_digits(scalars, c)).all()
    recomposed = [sum(int(d) << (c * w) for w, d in enumerate(signed[:, i])) for i in range(40)]
    assert recomposed == [s % q for s in scalars]


def test_auto_window():
    assert M.auto_window(2049) == (8, False)
    assert M.auto_window(33) == (3, False)
    assert M.auto_window(1 << 14) == JM.auto_window(1 << 14)
    assert M.auto_window(1 << 20) == JM.auto_window(1 << 20)


@pytest.mark.parametrize(
    "n,signed", [(64, False), (128, True), (256, False), (512, True), (1024, False), (1024, True)]
)
def test_row_msm_matches_pippenger(n, signed, monkeypatch):
    """Under BZ_ROW_MSM every bucket run takes the complete law (K7), the
    window aggregation runs on K6's window kernel, once per bucket pass, and
    never on K3, and the result equals the host Pippenger's."""
    laws, calls = [], {"K3": 0, "K6": 0}

    def buckets_spy(spec, table, src, starts, complete):
        laws.append(complete)
        return plain_buckets(spec, table, src, starts, complete)

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        return wrapped

    plain_buckets = M.bucket_sums_plain
    monkeypatch.setattr(M, "bucket_sums_plain", buckets_spy)
    monkeypatch.setattr(M.C, "point_add", spy("K3", M.C.point_add))
    monkeypatch.setattr(M, "window_sums", spy("K3", M.window_sums))
    monkeypatch.setattr(M, "window_sums_planes", spy("K6", M.window_sums_planes))
    monkeypatch.setenv("BZ_ROW_MSM", "1")
    pts = _points(VESTA, n, 300 + n)
    pts[7] = None
    scalars = _scalars(VESTA, n, 301 + n)
    c = 7 if signed else None
    assert M.msm(VESTA, pts, scalars, "cpu", c=c, signed=signed) == REF_VESTA.pippenger(pts, scalars)
    assert laws == [True] and calls["K3"] == 0 and calls["K6"] == len(laws)


def test_row_msm_has_no_collision_redo(monkeypatch):
    """The collision case of test_collision_redoes_with_complete_law under
    BZ_ROW_MSM: one pass of the complete law, no flag."""
    monkeypatch.setenv("BZ_ROW_MSM", "1")
    spec = M.FieldSpec.make(VESTA.base.modulus)
    p = VESTA.mul(VESTA.generator, 12345)
    pts = [p] * M.COMPLETE_BELOW
    table = M.C.affine_table(spec, pts, "cpu")
    wsums, collision = M.msm_wsums(spec, table, ints_to_limbs([3] * len(pts), "cpu").view(1, -1, 8), 4, False)
    assert not collision
    assert M.host_window_fold(VESTA, M.C.jacobian_to_affine(spec, wsums), 4) == VESTA.mul(p, 3 * len(pts))


@pytest.mark.parametrize(
    "rows,nbuck", [(2, 4), (3, 256), (2, 513), (3, 6)], ids=["c2", "c8", "c10_signed", "m5"]
)
def test_window_sums_match_host_group_law(rows, nbuck):
    """window_sums (on the CPU its plain version, the two-level running
    sums) gives T = sum_b b S_b per row: unsigned c = 2 and c = 8, signed
    c = 10 (2^9 + 1 buckets) and m = 5, which no power-of-two segment
    divides; with empty, equal and opposite buckets."""
    spec = M.FieldSpec.make(VESTA.base.modulus)
    buckets, pts = bucket_rows(rows, nbuck, nbuck, "cpu")
    got = M.window_sums(spec, buckets, nbuck)
    assert got.shape == (rows, 3, 8)
    assert M.C.jacobian_to_affine(spec, got) == [host_window_sum(row) for row in pts]


@pytest.mark.parametrize(
    "rows,nbuck", [(2, 4), (3, 256), (2, 513), (3, 6)], ids=["c2", "c8", "c10_signed", "m5"]
)
def test_window_sums_planes_match_host_group_law(rows, nbuck):
    """window_sums_planes (K6's window kernel; on the CPU its plain version)
    on coordinate planes gives T = sum_b b S_b per row, at
    test_window_sums_match_host_group_law's shapes and buckets."""
    spec = M.FieldSpec.make(VESTA.base.modulus)
    buckets, pts = bucket_rows(rows, nbuck, nbuck, "cpu")
    got = M.window_sums_planes(spec, buckets.permute(2, 0, 1, 3).contiguous(), nbuck)
    assert got.shape == (3, rows, 8)
    assert M.C.jacobian_to_affine(spec, got.movedim(0, -2)) == [host_window_sum(row) for row in pts]


def test_window_sums_planes_plain_matches_jax():
    """K6's plain version against the JAX package's _aggregate_windows on
    the same Jacobian buckets, with empty, equal and opposite ones: equal
    affine points. On the CPU the reference adds with its jnp point_add (no
    Pallas kernel); it runs eagerly, since compiling its two scans costs
    minutes. m = 3 (an IPA round's c = 2) runs both levels (g = 2, G = 2)
    and the padding past m."""
    spec = M.FieldSpec.make(VESTA.base.modulus)
    rows, nbuck = 4, 4
    buckets, pts = bucket_rows(rows, nbuck, 41, "cpu")
    got = M.window_sums_planes_plain(spec, buckets.permute(2, 0, 1, 3).contiguous(), nbuck)
    # the reference's layout: rows x (nbuck + 1) slots, the last one the identity
    padded = torch.cat([buckets, M.C.infinity(spec, (rows, 1), "cpu")], dim=1).reshape(-1, 3, 8)
    leaves = [jnp.asarray(JL.ints_to_limbs(limbs_to_ints(padded[:, i]))) for i in range(3)]
    with jax.disable_jit():
        ref = JM._aggregate_windows(JL.FieldSpec.make(VESTA.base.modulus), JC.JacobianPoint(*leaves), rows, nbuck)
    want = ints_to_limbs([v for c in ref for v in JL.limbs_to_ints(np.asarray(c))], "cpu").view(3, rows, 8)
    affine = M.C.jacobian_to_affine(spec, got.movedim(0, -2))
    assert affine == M.C.jacobian_to_affine(spec, want.movedim(0, -2))
    assert affine == [host_window_sum(row) for row in pts]


@pytest.mark.parametrize("rows", [1, 2, 32, 352, 1024, 5000])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 255, 512])
def test_window_layout(rows, m):
    """The window kernels' split of a row: powers of two, threads x segment
    covers m by less than a doubling, at most a block, and at least 32
    threads a row (or every bucket) however many rows there are; above 32
    threads the rows fit in the resident threads (here 132 SMs x 2 blocks
    of 128)."""
    resident = 132 * 2 * M.WINDOW_BLOCK
    threads, seg = M.window_layout(rows, m, resident)
    assert threads & (threads - 1) == 0 and seg & (seg - 1) == 0
    assert m <= threads * seg < 2 * m or threads * seg == 1
    assert min(32, threads * seg) <= threads <= M.WINDOW_BLOCK
    assert threads <= 32 or rows * threads <= resident


def test_one_window_aggregation_per_bucket_pass(monkeypatch):
    """In the default configuration every msm_wsums call aggregates its
    windows once through window_sums, the collision redo included, so K3
    launches equal K2 plus K7 launches on the card."""
    calls = {"buckets": 0, "windows": 0}
    bucket_sums, window_sums = M.bucket_sums, M.window_sums

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        return wrapped

    monkeypatch.setattr(M, "bucket_sums", count("buckets", bucket_sums))
    monkeypatch.setattr(M, "window_sums", count("windows", window_sums))
    p = VESTA.mul(VESTA.generator, 12345)
    pts = [p] * M.COMPLETE_BELOW  # equal points, equal digits: K2 collides, K7 redoes
    assert M.msm(VESTA, pts, [3] * len(pts), "cpu") == VESTA.mul(p, 3 * len(pts))
    assert calls == {"buckets": 2, "windows": 2}
    assert M.msm(VESTA, pts[:5], [1, 2, 3, 4, 5], "cpu") == VESTA.mul(p, 15)
    assert calls == {"buckets": 3, "windows": 3}


def test_one_planar_window_aggregation_per_bucket_pass(monkeypatch):
    """Under BZ_ROW_MSM every msm_wsums call aggregates its windows once
    through window_sums_planes and never through window_sums or the
    lane-wise K6, so K6 launches equal K7 launches on the card; the complete
    law leaves no collision to redo."""
    monkeypatch.setenv("BZ_ROW_MSM", "1")
    calls = {"buckets": 0, "windows": 0, "planes": 0, "lane-wise": 0}

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        return wrapped

    for name, module, attr in (("buckets", M, "bucket_sums"), ("windows", M, "window_sums"),
                               ("planes", M, "window_sums_planes"), ("lane-wise", M.C, "point_add_planes")):
        monkeypatch.setattr(module, attr, count(name, getattr(module, attr)))
    p = VESTA.mul(VESTA.generator, 12345)
    pts = [p] * M.COMPLETE_BELOW
    assert M.msm(VESTA, pts, [3] * len(pts), "cpu") == VESTA.mul(p, 3 * len(pts))
    assert calls == {"buckets": 1, "windows": 0, "planes": 1, "lane-wise": 0}
    assert M.msm(VESTA, pts[:5], [1, 2, 3, 4, 5], "cpu") == VESTA.mul(p, 15)
    assert calls == {"buckets": 2, "windows": 0, "planes": 2, "lane-wise": 0}
