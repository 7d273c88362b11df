"""The port's parallel layer (battlezips_halo2_tpu_torch/parallel) on the CPU,
against the JAX package's (battlezips_halo2_tpu/parallel) on the 8-device
virtual CPU mesh of tests/conftest.py and against its host arithmetic.

The port's meshes here are lists of CPU devices (several shards on one
device), so every kernel runs its plain version at shard shapes and every
collective is a copy; the process-group form runs in two processes over
gloo (tools/torch_multihost_ntt.py). Inputs are made from numpy seeds. The
arithmetic is exact: every comparison is equality."""

import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from battlezips_halo2_tpu.curves import VESTA as REF_VESTA
from battlezips_halo2_tpu.fields import FP_SPEC as REF_FP_SPEC
from battlezips_halo2_tpu.fields import ints_to_limbs as ref_ints_to_limbs
from battlezips_halo2_tpu.fields import limb as REF_L
from battlezips_halo2_tpu.fields import limbs_to_ints as ref_limbs_to_ints
from battlezips_halo2_tpu.parallel import default_mesh as ref_default_mesh
from battlezips_halo2_tpu.parallel import distributed_ntt as ref_distributed_ntt
from battlezips_halo2_tpu.parallel.context import mesh_from_config as ref_mesh_from_config
from battlezips_halo2_tpu.parallel.context import use_mesh as ref_use_mesh
from battlezips_halo2_tpu.pcs.ipa import cached_params as ref_cached_params
from battlezips_halo2_tpu.plonk import keygen as ref_keygen
from battlezips_halo2_tpu.poly import transforms as REF_T
from battlezips_halo2_tpu.poly.domain import EvaluationDomain as RefDomain
from battlezips_halo2_tpu_torch import convert
from battlezips_halo2_tpu_torch.curves.host import VESTA
from battlezips_halo2_tpu_torch.fields import limb as L
from battlezips_halo2_tpu_torch.fields.host import FP
from battlezips_halo2_tpu_torch.fields.limb import FP_SPEC, ints_to_limbs, limbs_to_ints
from battlezips_halo2_tpu_torch.parallel import distributed, distributed_ntt, mesh_from_devices, sharded_msm
from battlezips_halo2_tpu_torch.parallel.collectives import Mesh, all_gather, all_to_all, psum, shard, unshard
from battlezips_halo2_tpu_torch.parallel.context import get_mesh, mesh_from_config, mesh_is_active, use_mesh
from battlezips_halo2_tpu_torch.parallel.msm import sharded_msm_many
from battlezips_halo2_tpu_torch.plonk import create_proof, verify_proof
from battlezips_halo2_tpu_torch.poly import transforms as T
from battlezips_halo2_tpu_torch.poly.domain import EvaluationDomain
from test_prover import MulCircuit as RefMulCircuit
from test_torch_inputs import MulCircuit

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "golden" / "mul_k5.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(d: int):
    return mesh_from_devices(["cpu"] * d)


def field_ints(seed: int, n: int, modulus: int) -> list[int]:
    """n elements below ``modulus`` from numpy's seeded generator (four
    64-bit words each)."""
    words = np.random.default_rng(seed).integers(0, 1 << 63, size=(n, 4), dtype=np.int64).tolist()
    return [sum(w << (64 * i) for i, w in enumerate(row)) % modulus for row in words]


def vesta_points(seed: int, n: int) -> list:
    return [VESTA.mul(VESTA.generator, k + 1) for k in field_ints(seed, n, 1 << 64)]


# ------------------------------------------------------------- collectives


def test_collectives_move_shards_in_one_process():
    mesh = cpu_mesh(4)
    xs = [torch.arange(4 * 3).view(4, 3) + 100 * i for i in range(4)]
    got = all_to_all(mesh, xs)
    for j in range(4):
        assert torch.equal(got[j], torch.stack([xs[i][j] for i in range(4)]))
    for g in all_gather(mesh, xs):
        assert torch.equal(g, torch.stack(xs))
    for s in psum(mesh, xs):
        assert torch.equal(s, sum(xs))
    t = torch.arange(2 * 8 * 3).view(2, 8, 3)
    parts = shard(mesh, t, 1)
    assert [tuple(p.shape) for p in parts] == [(2, 2, 3)] * 4
    assert torch.equal(unshard(mesh, parts, 1, "cpu"), t)
    with pytest.raises(ValueError):
        shard(mesh, torch.zeros(6, 3), 0)


def test_mesh_needs_matching_devices_and_is_thread_local():
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 3, ("dp", "tp"), shape=(2, 2))
    mesh = cpu_mesh(2)
    assert mesh.size == 2 and mesh.local() == [0, 1] and mesh.shape == {"shard": 2}
    assert get_mesh() is None and not mesh_is_active()
    with use_mesh(mesh):
        assert get_mesh() is mesh and mesh_is_active()
        with use_mesh(cpu_mesh(1)):
            assert not mesh_is_active()
        assert get_mesh() is mesh
    assert get_mesh() is None


def test_default_mesh_takes_cards_only():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        from battlezips_halo2_tpu_torch.parallel import default_mesh

        default_mesh(2)


def test_distributed_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("BZ_NUM_PROCS", raising=False)
    distributed.initialize(device="cpu")
    assert not distributed.is_multiprocess()
    assert distributed.host_local_slice(12) == slice(0, 12)


# --------------------------------------------------------------------- NTT


def test_distributed_ntt_matches_jax():
    """D = 8 shards at n = 2^8 against the JAX package's distributed_ntt on
    its default_mesh(8)."""
    dom = EvaluationDomain(8, 5)
    vals = field_ints(11, dom.n, FP.modulus)
    mesh = cpu_mesh(8)
    a = L.to_mont(FP_SPEC, ints_to_limbs(vals, "cpu"))
    out = distributed_ntt(mesh, dom.n, dom.omega, shard(mesh, a, 0))
    got = limbs_to_ints(L.from_mont(FP_SPEC, unshard(mesh, out, 0, "cpu")))
    ref_a = REF_L.to_mont(REF_FP_SPEC, ref_ints_to_limbs(vals))
    want = ref_limbs_to_ints(np.asarray(REF_L.from_mont(REF_FP_SPEC, ref_distributed_ntt(
        ref_default_mesh(8), dom.n, dom.omega, ref_a))))
    assert got == want


@pytest.fixture(scope="module")
def transform_case():
    """EvaluationDomain(8, 5) (n = 2^8, extended 2^11, both multiples of
    D^2 = 64) and three Lagrange columns, with the JAX package's unsharded
    transforms of them."""
    dom, ref_dom = EvaluationDomain(8, 5), RefDomain(8, 5)
    cols = [field_ints(20 + i, dom.n, FP.modulus) for i in range(3)]
    coeff = REF_T.batch_lagrange_to_coeff(ref_dom, cols)
    ext = REF_T.batch_coeff_to_extended(ref_dom, coeff)
    want = {
        "lagrange_to_coeff": (cols, coeff),
        "coeff_to_lagrange": (coeff, REF_T.batch_coeff_to_lagrange(ref_dom, coeff)),
        "coeff_to_extended": (coeff, ext),
        "extended_to_coeff": (ext, REF_T.batch_extended_to_coeff(ref_dom, ext)),
    }
    return dom, {k: ([list(map(int, c)) for c in a], [list(map(int, c)) for c in b]) for k, (a, b) in want.items()}


@pytest.mark.parametrize("name", ["lagrange_to_coeff", "coeff_to_lagrange", "coeff_to_extended", "extended_to_coeff"])
def test_sharded_basis_transforms_match_jax(transform_case, name):
    """Under use_mesh (8 CPU shards) each batch_* transform runs the 4-step
    NTT and equals the JAX package's unsharded transform."""
    dom, cases = transform_case
    given, want = cases[name]
    mesh = cpu_mesh(8)
    with use_mesh(mesh):
        got = getattr(T, f"batch_{name}")(dom, given, "cpu")
    assert [list(c) for c in got] == want
    size = dom.extended_n if "extended" in name else dom.n
    assert [k[1] for k in mesh.cache if k[0] == "twiddles"] == [size]
    assert mesh.unsharded == {}


def test_sharded_lagrange_limbs_and_gate(capsys):
    """lagrange_to_coeff_limbs (the iNTT of commit_lagrange_many) takes the
    mesh too; a size the shape gate refuses (n = 32 on D = 8: 32 is not a
    multiple of 64) runs unsharded, is counted on the mesh and named."""
    dom = EvaluationDomain(8, 5)
    vals = ints_to_limbs(field_ints(30, 2 * dom.n, FP.modulus), "cpu").view(2, dom.n, 8)
    want = T.lagrange_to_coeff_limbs(dom, vals)
    mesh = cpu_mesh(8)
    with use_mesh(mesh):
        assert torch.equal(T.lagrange_to_coeff_limbs(dom, vals), want)
        small = EvaluationDomain(5, 3)
        cols = [field_ints(31, small.n, FP.modulus)]
        got = T.batch_lagrange_to_coeff(small, cols, "cpu")
        T.batch_lagrange_to_coeff(small, cols, "cpu")
    assert got == T.batch_lagrange_to_coeff(small, cols, "cpu")
    assert mesh.unsharded == {32: 2}
    assert capsys.readouterr().err.count("not a multiple of D^2 = 64") == 1


# --------------------------------------------------------------------- MSM


@pytest.mark.parametrize("signed", [None, True], ids=["auto_window", "signed_c10"])
def test_sharded_msm_matches_host(signed):
    """D = 4, 256 points: the window picked from the shard size (c = 4,
    unsigned), and signed digits with c = 10 (as the reference's tests),
    against the JAX package's host Pippenger."""
    pts = vesta_points(40, 256)
    scalars = field_ints(41, 256, VESTA.scalar.modulus)
    scalars[0] = 0
    c = 10 if signed else None
    got = sharded_msm(VESTA, pts, scalars, cpu_mesh(4), c=c, signed=signed)
    assert got == REF_VESTA.pippenger(pts, scalars)


def test_sharded_msm_many_matches_host():
    """D = 4 over 33 points (padded to 256 with the generator): three
    scalar vectors, one zero past the first shard (the other shards' partials
    are the identity) and one all zero."""
    pts = vesta_points(50, 33)
    scalars = [field_ints(51, 33, VESTA.scalar.modulus), field_ints(52, 5, VESTA.scalar.modulus) + [0] * 28,
               [0] * 33]
    got = sharded_msm_many(VESTA, pts, scalars, cpu_mesh(4))
    assert got == [REF_VESTA.pippenger(pts, s) for s in scalars[:2]] + [None]


# ------------------------------------------------------------------ proofs


def test_mul_proof_under_mesh_matches_golden():
    """A k = 5 MulCircuit proof under use_mesh (2 CPU shards), keys from the
    JAX package by convert.py: every commitment is the sharded MSM (its
    [G | W] shards cached on the params) and the iNTTs of the commit passes
    the 4-step NTT; the bytes equal tests/golden/mul_k5.json and the
    unsharded port's, and verify."""
    ref_params = ref_cached_params(5)
    params = convert.params_from_reference(ref_params, device="cpu")
    pk = convert.proving_key_from_reference(ref_keygen(ref_params, RefMulCircuit(1, 1, 1)), MulCircuit(1, 1, 1))
    mesh = cpu_mesh(2)
    with use_mesh(mesh):
        sharded = create_proof(params, pk, MulCircuit(3, 5, 15), [[15]], random.Random(GOLDEN["seed"]))
    assert sharded.hex() == GOLDEN["proof_hex"]
    assert list(params.__dict__["_mesh_tables"]) == [mesh.key]
    assert ("twiddles", 32, pow(pk.vk.domain.omega, -1, FP.modulus)) in mesh.cache
    assert mesh.unsharded == {}
    assert sharded == create_proof(params, pk, MulCircuit(3, 5, 15), [[15]], random.Random(GOLDEN["seed"]))
    assert verify_proof(params, pk.vk, sharded, [[15]])


# ------------------------------------------------------------ mesh config


def test_mesh_from_config_builds_requested_shape(monkeypatch):
    """BZ_MESH_DP / BZ_MESH_TP shape the mesh as in the reference
    (tests/test_config.py)."""
    devices = ["cpu"] * 8
    monkeypatch.setenv("BZ_MESH_DP", "2")
    monkeypatch.setenv("BZ_MESH_TP", "4")
    mesh = mesh_from_config(devices)
    assert mesh.shape == {"dp": 2, "tp": 4} == dict(ref_mesh_from_config().shape)
    monkeypatch.delenv("BZ_MESH_DP")
    monkeypatch.setenv("BZ_MESH_TP", "8")
    assert mesh_from_config(devices).shape == {"dp": 1, "tp": 8} == dict(ref_mesh_from_config().shape)
    monkeypatch.delenv("BZ_MESH_TP")
    assert mesh_from_config(devices).shape == {"dp": 1, "tp": 8}
    assert mesh_from_config(["cpu"]) is None
    monkeypatch.setenv("BZ_MESH_DP", "3")
    with pytest.raises(ValueError):
        mesh_from_config(["cpu"] * 2)


def test_dp_tp_mesh_raises_like_the_reference(monkeypatch):
    """The reference's fault, kept: mesh_from_config names its axes
    ("dp", "tp") while the sharded NTT and MSM shard over "shard", so under
    use_mesh a transform that the mesh takes raises ValueError, in both
    packages (a 1 x 4 mesh, n = 32)."""
    monkeypatch.setenv("BZ_MESH_DP", "1")
    monkeypatch.setenv("BZ_MESH_TP", "4")
    dom = EvaluationDomain(5, 3)
    cols = [field_ints(60, dom.n, FP.modulus)]
    with use_mesh(mesh_from_config(["cpu"] * 4)):
        with pytest.raises(ValueError, match=r"\('dp', 'tp'\)"):
            T.batch_coeff_to_lagrange(dom, cols, "cpu")
        with pytest.raises(ValueError, match=r"\('dp', 'tp'\)"):
            sharded_msm(VESTA, vesta_points(61, 4), [1, 2, 3, 4], get_mesh())
    with ref_use_mesh(ref_mesh_from_config()):
        with pytest.raises(ValueError, match="shard"):
            REF_T.batch_coeff_to_lagrange(RefDomain(5, 3), cols)


# ------------------------------------------------------------ processes


def test_multihost_ntt_over_gloo_two_processes():
    """tools/torch_multihost_ntt.py: two processes over gloo, each checking
    its NTT shard against the host NTT and a sharded MSM (partials
    all-gathered across the processes) against the host Pippenger."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_multihost_ntt.py"), "--device", "cpu", "--procs", "2",
         "--logn", "8", "--timeout", "300"],
        capture_output=True, text=True, timeout=400, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "torch_multihost_ntt: OK" in proc.stdout
    assert proc.stdout.count("rows bit-exact") == 2 and proc.stdout.count("equals the host Pippenger") == 2
