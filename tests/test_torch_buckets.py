"""K2 / K7's plain version on the kernel's schedule
(ops/msm.py::bucket_sums_plain: equal chunks of sorted rows, then the runs
that cross a chunk boundary merged with the complete law) and its chunk
length (``bucket_layout``), on the CPU. Bucket sums are held against the
JAX package's host group law (affine, exact) and the collision flags
against a host walk of the same chunks; ``bucket_runs``' bucket ids
against its runs."""

import random

import pytest
import torch

from battlezips_halo2_tpu.curves.host import VESTA as REF_VESTA
from battlezips_halo2_tpu_torch.curves import limb as C
from battlezips_halo2_tpu_torch.curves.host import VESTA
from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC, ints_to_limbs
from battlezips_halo2_tpu_torch.ops import msm as M
from test_torch_inputs import hand_bucket_runs, host_bucket_walk


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("rows", [0, 1, 5, 127, 128, 129, 50688, 1442144])
@pytest.mark.parametrize("resident", [128, 50688, 67584])
@pytest.mark.parametrize("longest", [0, 8, 47, 2049])
def test_bucket_layout(rows, resident, longest):
    """The shortest chunks that one wave of ``resident`` threads covers, or
    a BUCKET_SPAN-th of the longest run if that is longer: at most one
    chunk a thread, the last one partial, and one row shorter would need
    more threads than the wave holds or cut the longest run into more than
    BUCKET_SPAN chunks' worth."""
    longest = min(longest, rows)
    chunk, chunks = M.bucket_layout(rows, resident, longest)
    assert chunk >= 1 and chunks <= resident
    assert chunks == -(-rows // chunk) and (chunks - 1) * chunk < rows <= chunks * chunk or rows == chunks == 0
    assert chunk * M.BUCKET_SPAN >= longest
    assert chunk == 1 or -(-rows // (chunk - 1)) > resident or (chunk - 1) * M.BUCKET_SPAN < longest


@pytest.mark.parametrize(
    "layout,chunk", [(3, 1), (3, 2), (3, 3), (4, 4), (3, 10**4)], ids=["L1", "L2", "L3", "L4", "L_ge_rows"]
)
@pytest.mark.parametrize("complete", [False, True], ids=["K2", "K7"])
def test_plain_schedule_matches_host_group_law(layout, chunk, complete):
    """Runs laid out for chunks of ``layout`` rows (empty runs, identity
    heads and rows, P then -P, P then P inside a chunk and across a
    boundary, a run over several chunks), summed with chunk length
    ``chunk``: affine sums equal the host group law wherever the flag is 0
    (everywhere for the complete law), and the flags are exactly the
    in-chunk P == Q meetings of the incomplete law."""
    table, src, starts, _, points, kinds = hand_bucket_runs(12, layout, 30, 1 + layout, "cpu")
    out, flags = M.bucket_sums_plain(FQ_SPEC, table, src, starts, complete, chunk=chunk)
    want, want_flags = host_bucket_walk(REF_VESTA, points, src.tolist(), starts.tolist(), chunk, complete)
    assert flags.tolist() == want_flags
    got = C.jacobian_to_affine(FQ_SPEC, out)
    assert [g for g, f in zip(got, want_flags) if not f] == [w for w, f in zip(want, want_flags) if not f]
    if not complete and chunk == layout:
        assert all(flags[b] for b, k in enumerate(kinds) if k == 1)  # P then P inside a chunk
        assert not any(flags[b] for b, k in enumerate(kinds) if k == 5)  # split by a boundary: merged completely
    assert complete or chunk == 1 or flags.any()


def test_plain_schedule_long_run_and_empty_pass():
    """One bucket of 200 equal-scalar rows split over 67 chunks of 3 (64 of
    them wholly inside it), between empty buckets; and a pass whose
    buckets are all empty gives the identity everywhere."""
    rng = random.Random(9)
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 64)) for _ in range(200)]
    table = C.affine_table(FQ_SPEC, pts, "cpu")
    src = torch.arange(200, dtype=torch.int32)
    starts = torch.tensor([0, 0, 0, 200, 200], dtype=torch.int32)
    for complete in (False, True):
        out, flags = M.bucket_sums_plain(FQ_SPEC, table, src, starts, complete, chunk=3)
        total = None
        for p in pts:
            total = REF_VESTA.add(total, p)
        assert C.jacobian_to_affine(FQ_SPEC, out) == [None, None, total, None]
        assert not flags.any()
    out, flags = M.bucket_sums_plain(FQ_SPEC, table, src, torch.zeros(5, dtype=torch.int32), False)
    assert torch.equal(out, C.infinity(FQ_SPEC, (4,), "cpu")) and not flags.any()


@pytest.mark.parametrize("signed", [False, True])
def test_bucket_runs_bucket_ids(signed):
    """bucket_runs' bid names the bucket of every sorted row: the live rows'
    buckets follow starts, and the digit-0 rows after them carry B W nbuck."""
    rng = random.Random(3)
    n, c = 40, 4
    table = C.affine_table(FQ_SPEC, [VESTA.mul(VESTA.generator, i + 1) for i in range(n)], "cpu")
    scalars = [rng.randrange(VESTA.scalar.modulus) for _ in range(2 * n)]
    scalars[:5] = [0] * 5
    lim = ints_to_limbs(scalars, "cpu").view(2, n, 8)
    _, src, starts, nbuck, bid = M.bucket_runs(FQ_SPEC, table, lim, c, signed)
    nb = starts.shape[0] - 1
    live = int(starts[-1])
    assert bid.dtype == torch.int32 and bid.shape == src.shape
    assert torch.equal(bid[:live], torch.repeat_interleave(torch.arange(nb, dtype=torch.int32), starts.diff()))
    assert (bid[live:] == nb).all() and nb % nbuck == 0
