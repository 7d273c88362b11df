"""The port's native host engine (battlezips_halo2_tpu_torch/native, its own
copy of pasta.cpp built into csrc/build/host-<hash>/) against the JAX
package's native runtime, on the CPU.

Every bound function gives the same bytes as the reference's on the same
seeded inputs (n = 2^8-2^10); the library builds with g++ into the port's
build directory and binds every entry; a failed build raises wherever an
engine that needs it is selected and nothing falls back; under the
default device engine a proof never loads the library; the host math
sites, the transforms and the native quotient equal their Python and
plain-torch versions; ops/cuda.py::library() refuses a kernel library
that lacks an entry. Exact comparisons (tolerance 0)."""

import ctypes
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from battlezips_halo2_tpu import native as ref_native
from battlezips_halo2_tpu_torch import native
from battlezips_halo2_tpu_torch.curves.host import PALLAS, VESTA
from battlezips_halo2_tpu_torch.fields.host import FP, FQ
from battlezips_halo2_tpu_torch.poly.domain import EvaluationDomain, eval_poly_coeffs

ROOT = Path(__file__).resolve().parent.parent
P, Q = FP.modulus, FQ.modulus


def _ints(rng, n, m=P):
    """n seeded field elements (256 random bits mod m)."""
    words = rng.integers(0, 2**63, size=(n, 5), dtype=np.int64).tolist()
    return [sum(w << (63 * i) for i, w in enumerate(row)) % m for row in words]


def _points(rng, curve, count):
    return [curve.mul(curve.generator, int(s)) for s in rng.integers(1, 2**62, size=count)]


def _case(name, rng):
    """(port result, reference result) of one bound function on seeded
    inputs; arrays compare by their bytes."""
    which = native.which_for(P)
    xs, ys = _ints(rng, 256), _ints(rng, 256)
    if name == "which_for":
        return ([native.which_for(m) for m in (P, Q)], [ref_native.which_for(m) for m in (P, Q)])
    if name == "marshal":
        arr = native.ints_to_bytes_arr(xs)
        return ((arr.tobytes(), native.bytes_arr_to_ints(arr)),
                (ref_native.ints_to_bytes_arr(xs).tobytes(), ref_native.bytes_arr_to_ints(arr)))
    if name == "mul_batch":
        return native.mul_batch(which, xs, ys), ref_native.mul_batch(which, xs, ys, P)
    if name == "inv_batch":
        return native.inv_batch(native.FIELD_FQ, [x % Q or 1 for x in xs]), ref_native.inv_batch(
            ref_native.FIELD_FQ, [x % Q or 1 for x in xs])
    if name == "inv_vec":
        arr = native.ints_to_bytes_arr([x or 1 for x in xs])
        return native.inv_vec(which, arr).tobytes(), ref_native.inv_vec(which, arr).tobytes()
    if name == "find_z":
        y8 = xs[:8]
        return native.find_z(which, y8), ref_native.find_z(which, y8)
    if name in ("ntt_batch", "scale_batch"):
        dom = EvaluationDomain(9, 2)
        data = np.stack([native.ints_to_bytes_arr(_ints(rng, dom.n)) for _ in range(3)])
        ours, theirs = data.copy(), data.copy()
        if name == "ntt_batch":
            native.ntt_batch(which, ours, dom.omega)
            ref_native.ntt_batch(which, theirs, dom.omega)
        else:
            native.scale_batch(which, ours, dom.g_coset, xs[0])
            ref_native.scale_batch(which, theirs, dom.g_coset, xs[0])
        return ours.tobytes(), theirs.tobytes()
    if name == "vm_exec":
        regs = np.stack([native.ints_to_bytes_arr(_ints(rng, 512)) for _ in range(6)])
        # (op, a, b, dst): mul, add, sub over pins 1-3 and temps 4-5, folded into register 0
        prog = np.array([[0, 1, 2, 4], [1, 4, 3, 5], [2, 5, 1, 4], [0, 0, 3, 5], [1, 5, 4, 0]], np.int32)
        return native.vm_exec(which, prog, regs).tobytes(), ref_native.vm_exec(which, prog, regs).tobytes()
    a, b = native.ints_to_bytes_arr(xs), native.ints_to_bytes_arr(ys)
    if name == "mul_vec":
        return native.mul_vec(which, a, b).tobytes(), ref_native.mul_vec(which, a, b).tobytes()
    if name == "axpy":
        return native.axpy(which, a, ys[0], b).tobytes(), ref_native.axpy(which, a, ys[0], b).tobytes()
    if name == "horner":
        return native.horner(which, a, ys[0]), ref_native.horner(which, a, ys[0])
    if name == "inner":
        return native.inner(which, a, b), ref_native.inner(which, a, b)
    if name == "div_linear":
        ours, theirs = a.copy(), a.copy()
        return ((native.div_linear(which, ours, ys[0]), ours.tobytes()),
                (ref_native.div_linear(which, theirs, ys[0]), theirs.tobytes()))
    if name == "point_decompress":
        pts = _points(rng, VESTA, 16) + [None]
        enc = b"".join(VESTA.to_bytes(p) for p in pts) + b"\xff" * 32  # the last is malformed
        w = native.which_for(VESTA.base.modulus)
        ours, theirs = native.point_decompress(w, enc), ref_native.point_decompress(w, enc)
        return ((ours[0].tobytes(), ours[1].tobytes(), ours[2]), (theirs[0].tobytes(), theirs[1].tobytes(), theirs[2]))
    if name == "ipa_s_vector":
        return native.ipa_s_vector(which, xs[:10], ys[0], 1 << 10).tobytes(), ref_native.ipa_s_vector(
            which, xs[:10], ys[0], 1 << 10).tobytes()
    if name == "grand_product":
        return native.grand_product(which, a, b, xs[1]).tobytes(), ref_native.grand_product(which, a, b, xs[1]).tobytes()
    w = native.which_for(VESTA.base.modulus)
    pts = _points(rng, VESTA, 40) + [None]
    scalars = _ints(rng, len(pts))
    if name == "points_buffer":
        return native.points_buffer(pts), ref_native.points_buffer(pts)
    if name == "window_fold_batch":
        return native.window_fold_batch(w, pts[:40], 4, 10, 8), ref_native.window_fold_batch(w, pts[:40], 4, 10, 8)
    pbuf = native.points_buffer(pts)
    if name == "msm_buf":
        return native.msm_buf(w, pbuf, scalars), ref_native.msm_buf(w, pbuf, scalars)
    if name == "msm_buf_scalars":
        sarr = native.ints_to_bytes_arr(scalars)
        return native.msm_buf_scalars(w, pbuf, sarr), ref_native.msm_buf_scalars(w, pbuf, sarr)
    assert name == "msm"
    return native.msm(w, pts, scalars), ref_native.msm(w, pts, scalars)


BOUND = ("which_for", "marshal", "mul_batch", "inv_batch", "inv_vec", "find_z", "ntt_batch", "scale_batch", "vm_exec",
         "mul_vec", "axpy", "horner", "inner", "div_linear", "point_decompress", "ipa_s_vector", "grand_product",
         "points_buffer", "window_fold_batch", "msm_buf", "msm_buf_scalars", "msm")


@pytest.mark.parametrize("name", BOUND)
def test_bound_function_matches_reference(name):
    assert ref_native.available()
    ours, theirs = _case(name, np.random.default_rng(BOUND.index(name)))
    assert ours == theirs


def test_values_match_python_ints():
    """A few of the native results against exact Python ints."""
    rng = np.random.default_rng(1)
    xs = _ints(rng, 300)
    assert native.inv_batch(native.FIELD_FP, xs) == [pow(x, -1, P) for x in xs]
    coeffs = native.ints_to_bytes_arr(xs)
    assert native.horner(native.FIELD_FP, coeffs, xs[0]) == eval_poly_coeffs(xs, xs[0])
    pts = _points(rng, VESTA, 33)
    assert native.msm(native.which_for(Q), pts, xs[:33]) == VESTA.msm(pts, xs[:33])
    assert native.points_buffer([None]) == b"\x00" * 64


def test_library_builds_in_the_port_and_binds_every_entry(monkeypatch):
    path = native.library_path()
    assert path.parent.parent == ROOT / "battlezips_halo2_tpu_torch" / "csrc" / "build"
    assert path.parent.name.startswith("host-")
    assert native.SOURCE == ROOT / "battlezips_halo2_tpu_torch" / "csrc" / "pasta.cpp"
    lib = native.load()
    assert Path(lib._name) == path
    for name in native._SIGNATURES:
        assert getattr(lib, name).argtypes
    assert native.build_command(Path("x")) == ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                                               str(native.SOURCE), "-o", "x"]
    # the hash covers the compiler command and the CPU: either changed builds elsewhere
    monkeypatch.setattr(native, "CXX", "clang++")
    assert native.library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(native, "_cpu_model", lambda: "another CPU")
    assert native.library_path() != path


def test_bind_raises_on_a_missing_entry(tmp_path):
    src = tmp_path / "stub.c"
    src.write_text("\n".join(f"void {name}(void) {{}}" for name in list(native._SIGNATURES)[1:]))
    lib = tmp_path / "stub.so"
    subprocess.run(["gcc", "-shared", "-fPIC", str(src), "-o", str(lib)], check=True)
    with pytest.raises(RuntimeError, match=list(native._SIGNATURES)[0]):
        native.bind(lib)


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    """A compiler that cannot be found, and no library loaded yet."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_lib", None)


@pytest.mark.parametrize("engine", ["host", "auto"])
def test_failed_build_raises_and_never_falls_back(broken_compiler, monkeypatch, engine):
    from battlezips_halo2_tpu_torch.ops.engine import use_host_engine
    from battlezips_halo2_tpu_torch.plonk.batch_prover import _batch_engine

    monkeypatch.setenv("BZ_PROOF_ENGINE", engine)
    with pytest.raises(RuntimeError, match="does not build"):
        native.load()
    assert not native.library_path().parent.exists()  # a failed build leaves no directory behind
    with pytest.raises(RuntimeError, match="does not build"):
        use_host_engine(1 << 5)
    with pytest.raises(RuntimeError, match="does not build"):
        FP.batch_inv(list(range(1, 100)))
    with pytest.raises(RuntimeError, match="does not build"):
        eval_poly_coeffs(_poly_with_bytes(), 3)
    monkeypatch.setenv("BZ_PROOF_ENGINE", "device")
    with pytest.raises(RuntimeError, match="does not build"):
        _batch_engine("host")
    assert _batch_engine("auto") == "device" and native._lib is None
    assert FP.batch_inv([2] * 70) == [pow(2, -1, P)] * 70  # the device engine needs no library


def _poly_with_bytes():
    from battlezips_halo2_tpu_torch.poly.polyints import PolyInts

    return PolyInts.wrap([1, 2, 3], np.zeros((3, 32), np.uint8))


def test_device_engine_never_loads_the_library():
    """A k=5 proof and its verification under the default engine, in a
    fresh process, leave native._lib unloaded."""
    code = """
import random, sys
sys.path.insert(0, "tests")
import torch
torch.set_num_threads(1)
from battlezips_halo2_tpu_torch import native
from battlezips_halo2_tpu_torch.pcs.ipa import Params
from battlezips_halo2_tpu_torch.plonk import create_proof, keygen, verify_proof
from test_torch_inputs import MulCircuit
params = Params.new(5, device="cpu")
pk = keygen(params, MulCircuit(1, 1, 1))
proof = create_proof(params, pk, MulCircuit(3, 5, 15), [[15]], random.Random(1))
assert verify_proof(params, pk.vk, proof, [[15]])
print("loaded" if native._lib is not None else "unloaded")
"""
    env = {k: v for k, v in __import__("os").environ.items() if k not in ("BZ_PROOF_ENGINE", "BZ_BATCH_ENGINE")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "unloaded"


def test_polyints_mutation_drops_bytes():
    from battlezips_halo2_tpu_torch.poly.polyints import PolyInts

    mutations = [lambda p: p.__setitem__(0, 5), lambda p: p.append(1), lambda p: p.extend([1]),
                 lambda p: p.insert(0, 1), lambda p: p.pop(), lambda p: p.remove(2), lambda p: p.sort(),
                 lambda p: p.reverse(), lambda p: p.clear(), lambda p: p.__delitem__(0),
                 lambda p: p.__iadd__([4]), lambda p: p.__imul__(2)]
    for mutate in mutations:
        p = PolyInts.wrap([1, 2, 3], native.ints_to_bytes_arr([1, 2, 3]))
        assert p.bytes_arr is not None and p == [1, 2, 3]
        mutate(p)
        assert getattr(p, "bytes_arr", None) is None
    p = PolyInts.wrap([1, 2, 3], native.ints_to_bytes_arr([1, 2, 3]))
    assert getattr(p[:2], "bytes_arr", None) is None and p[:2] == [1, 2]


def test_host_math_routes_match_python(monkeypatch):
    """Batch inversion, Pippenger, point decoding, find_z and Horner on the
    native engine (BZ_PROOF_ENGINE=auto) equal the Python versions
    (device)."""
    from battlezips_halo2_tpu_torch.gadgets.fixed_bases import find_z
    from battlezips_halo2_tpu_torch.poly.polyints import PolyInts

    rng = np.random.default_rng(3)
    xs = _ints(rng, 80)
    pts = _points(rng, PALLAS, 34) + [None]
    vpts = _points(rng, VESTA, 4)
    encodings = [VESTA.to_bytes(p) for p in vpts] + [b"\x00" * 32]
    poly = PolyInts.wrap(xs, native.ints_to_bytes_arr(xs))
    # seed 453 gives ys whose witness is z = 21: the Python scan stays short
    ys = [int(y) for y in np.random.default_rng(453).integers(1, 10**6, size=8)]

    def run(coeffs):
        return (FP.batch_inv(xs), FQ.batch_inv([x % Q or 1 for x in xs]), PALLAS.pippenger(pts, xs[:35]),
                [VESTA.from_bytes(e) for e in encodings], eval_poly_coeffs(coeffs, xs[1]), find_z(ys))

    monkeypatch.setenv("BZ_PROOF_ENGINE", "device")
    want = run(list(poly))  # a plain list: Horner in Python ints
    monkeypatch.setenv("BZ_PROOF_ENGINE", "auto")
    assert run(poly) == want  # a PolyInts: Horner on the native engine
    for engine in ("device", "auto"):  # a non-canonical x is refused on either engine
        monkeypatch.setenv("BZ_PROOF_ENGINE", engine)
        with pytest.raises(ValueError):
            VESTA.from_bytes(b"\xff" * 32)


def test_transforms_route_native(monkeypatch):
    """poly/transforms.py's four batch transforms on the native engine equal
    the plain-torch device path, and return PolyInts with their bytes."""
    from battlezips_halo2_tpu_torch.poly import transforms as T

    rng = np.random.default_rng(14)
    dom = EvaluationDomain(6, 3)
    cols = [_ints(rng, dom.n) for _ in range(3)]

    def run():
        coeffs = T.batch_lagrange_to_coeff(dom, cols, "cpu")
        ext = T.batch_coeff_to_extended(dom, coeffs, "cpu")
        return coeffs, T.batch_coeff_to_lagrange(dom, coeffs, "cpu"), ext, T.batch_extended_to_coeff(dom, ext, "cpu")

    monkeypatch.setenv("BZ_PROOF_ENGINE", "device")
    want = run()
    monkeypatch.setenv("BZ_PROOF_ENGINE", "host")
    got = run()
    assert got == want and got[1] == cols
    for polys in got:
        assert all(native.bytes_arr_to_ints(p.bytes_arr) == p for p in polys)
    # auto: a domain above latency_n_max stays on the device path
    monkeypatch.setenv("BZ_PROOF_ENGINE", "auto")
    monkeypatch.setenv("BZ_LATENCY_N_MAX", str(dom.n // 2))
    assert getattr(T.batch_lagrange_to_coeff(dom, cols, "cpu")[0], "bytes_arr", None) is None


def test_native_quotient_matches_device_and_reference(monkeypatch):
    """NativeQuotientEvaluator on the k=5 keys equals the port's device
    evaluator (plain versions) and the JAX package's native evaluator on
    seeded random polynomials; the quotient constants built natively
    equal the Python ones."""
    from battlezips_halo2_tpu.ops.native_quotient import NativeQuotientEvaluator as RefNativeQuotientEvaluator
    from battlezips_halo2_tpu.pcs.ipa import cached_params as ref_cached_params
    from battlezips_halo2_tpu.plonk import keygen as ref_keygen
    from battlezips_halo2_tpu.plonk.arguments import ProofSchedule as RefProofSchedule
    from battlezips_halo2_tpu_torch import convert
    from battlezips_halo2_tpu_torch.ops import gate_eval as GE
    from battlezips_halo2_tpu_torch.ops.gate_eval import BatchQuotientEvaluator
    from battlezips_halo2_tpu_torch.ops.native_quotient import NativeQuotientEvaluator
    from battlezips_halo2_tpu_torch.plonk.arguments import ProofSchedule
    from test_prover import MulCircuit as RefMulCircuit
    from test_torch_inputs import MulCircuit

    ref_pk = ref_keygen(ref_cached_params(5), RefMulCircuit(1, 1, 1))
    vk = convert.proving_key_from_reference(ref_pk, MulCircuit(1, 1, 1)).vk
    schedule = ProofSchedule.build(vk.cs)
    monkeypatch.setenv("BZ_PROOF_ENGINE", "device")
    plain_constants = GE.quotient_constants(vk)
    monkeypatch.setenv("BZ_PROOF_ENGINE", "auto")  # the constants on the native engine, as PolyInts
    native_constants = GE.quotient_constants(vk)
    assert {k: list(v) for k, v in native_constants.items()} == plain_constants
    assert all(native.bytes_arr_to_ints(v.bytes_arr) == v for v in native_constants.values())
    ev = NativeQuotientEvaluator(vk, schedule)
    rng = random.Random(8)
    polys = {k: [rng.randrange(P) for _ in range(vk.domain.n)] for k in ev.keys}
    chals = tuple(rng.randrange(P) for _ in range(4))
    got = ev(polys, chals)
    assert got == BatchQuotientEvaluator(vk, schedule, "cpu")([polys], [chals])[0]
    ref = RefNativeQuotientEvaluator(ref_pk.vk, RefProofSchedule.build(ref_pk.vk.cs))
    assert got == ref(polys, chals)


def test_cuda_library_requires_every_entry(monkeypatch, tmp_path):
    """ops/cuda.py::library() refuses a built kernel library that lacks an
    entry of _SIGNATURES, naming it."""
    from battlezips_halo2_tpu_torch.ops import cuda

    names = list(cuda._SIGNATURES)
    src = tmp_path / "stub.c"
    src.write_text("\n".join(f"int {name}(void) {{ return 0; }}" for name in names if name != "bz_ntt_stage"))
    lib = tmp_path / "libstub.so"
    subprocess.run(["gcc", "-shared", "-fPIC", str(src), "-o", str(lib)], check=True)
    monkeypatch.setattr(cuda, "build", lambda *a, **kw: lib)
    monkeypatch.setattr(cuda, "_lib", None)
    with pytest.raises(RuntimeError, match="bz_ntt_stage"):
        cuda.library()
    assert cuda._lib is None
    full = tmp_path / "libfull.so"
    src.write_text("\n".join(f"int {name}(void) {{ return 0; }}" for name in names))
    subprocess.run(["gcc", "-shared", "-fPIC", str(src), "-o", str(full)], check=True)
    monkeypatch.setattr(cuda, "build", lambda *a, **kw: full)
    assert isinstance(cuda.library(), ctypes.CDLL)
