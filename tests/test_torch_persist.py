"""The port's artifact store (battlezips_halo2_tpu_torch/artifacts.py): the
SRS (pcs/ipa.py::Params.save / load, cached_params), the proving keys
(plonk/keys.py::ProvingKey.save / load, api._cached_pk) and the fixed-base
z tables, on the CPU at k = 4 / 5 (MulCircuit), with
tests/test_infra.py::TestPersistence as the model.

Round trips keep every value; a key saved with every process cache
attached holds no tensor and no native handle, and keeps its caches in
memory; a loaded key proves tests/golden/mul_k5.json and the JAX package's
bytes; a second process-level lookup loads and derives nothing; a corrupt
file is reported and rebuilt; the port's files share no name with the JAX
package's. Every file goes under tmp_path."""

import ctypes
import json
import pickle
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from battlezips_halo2_tpu.pcs.ipa import Params as RefParams
from battlezips_halo2_tpu.plonk import create_proof as ref_create_proof
from battlezips_halo2_tpu.plonk import keygen as ref_keygen
from battlezips_halo2_tpu_torch import api, artifacts
from battlezips_halo2_tpu_torch.curves import hashtocurve
from battlezips_halo2_tpu_torch.gadgets import fixed_bases
from battlezips_halo2_tpu_torch.pcs.ipa import Params, cached_params
from battlezips_halo2_tpu_torch.plonk import create_proof, keygen, verify_proof
from battlezips_halo2_tpu_torch.plonk.keys import PK_PROCESS_CACHES, VK_PROCESS_CACHES, ProvingKey
from test_prover import MulCircuit as RefMulCircuit
from test_torch_inputs import MulCircuit

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "golden" / "mul_k5.json").read_text())
# the JAX package's artifact names (battlezips_halo2_tpu/api.py, pcs/ipa.py, gadgets/fixed_bases.py)
JAX_NAMES = re.compile(r"srs_h2c_\d+\.json|pk_h2c_\w+_\d+_v5\.pkl|fixed_base_zs_[A-Za-z]+\.json")
DEFAULT_HOME = artifacts.directory


@pytest.fixture(autouse=True)
def store(tmp_path, monkeypatch):
    """The artifact home under tmp_path, nothing cached in the process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(artifacts, "directory", lambda: tmp_path / "torch")
    artifacts.forget()
    yield tmp_path / "torch"
    artifacts.forget()
    torch.set_num_threads(threads)


def mul_pk(params):
    return api._cached_pk("mul", params, lambda: MulCircuit(1, 1, 1))


def store_files(store) -> dict:
    return {p.name: p for p in store.iterdir()}


@pytest.mark.parametrize("k", [4, 5])
def test_params_round_trip(store, k):
    params = Params.new(k, device="cpu")
    path = store / "srs.json"
    params.save(path)
    assert set(json.loads(path.read_text())) == {"k", "g", "u", "w"}
    loaded = Params.load(path, device="cpu")
    assert (loaded.k, loaded.g, loaded.u, loaded.w) == (params.k, params.g, params.u, params.w)
    assert loaded.device == torch.device("cpu") and loaded._gw_table is None


@pytest.mark.parametrize("fault", ["short G", "off the curve", "out of the field"])
def test_params_load_refuses_a_bad_file(store, fault):
    params = Params.new(4, device="cpu")
    path = store / "srs.json"
    params.save(path)
    data = json.loads(path.read_text())
    if fault == "short G":
        data["g"].pop()
    elif fault == "off the curve":
        data["u"][1] = hex(int(data["u"][1], 16) ^ 1)
    else:
        data["w"][0] = hex(1 << 256)
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError):
        Params.load(path, device="cpu")


def test_proving_key_round_trip_equals_jax_digest(store):
    params = Params.new(5, device="cpu")
    pk = keygen(params, MulCircuit(1, 1, 1))
    pk.save(store / "pk.pkl")
    loaded = ProvingKey.load(store / "pk.pkl")
    assert loaded.fixed_values == pk.fixed_values and loaded.fixed_polys == pk.fixed_polys
    assert loaded.vk.fixed_commitments == pk.vk.fixed_commitments
    perm, want = loaded.vk.permutation, pk.vk.permutation
    assert (perm.sigmas, perm.sigma_polys, perm.sigma_commitments) == (want.sigmas, want.sigma_polys,
                                                                         want.sigma_commitments)
    assert loaded.vk.digest == pk.vk.digest == int(GOLDEN["vk_digest"], 16)
    ref_pk = ref_keygen(RefParams.new(5), RefMulCircuit(1, 1, 1))
    assert loaded.vk.digest == ref_pk.vk.digest


def _graph(obj):
    """Every object reachable from ``obj`` through containers, __dict__ and
    __slots__."""
    seen, stack = set(), [obj]
    while stack:
        o = stack.pop()
        if id(o) in seen or isinstance(o, type):
            continue
        seen.add(id(o))
        yield o
        if isinstance(o, dict):
            stack += list(o.keys()) + list(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack += list(o)
        stack += list(getattr(o, "__dict__", {}).values())  # a container's subclass too (PolyInts)
        stack += [getattr(o, s) for c in type(o).__mro__ for s in getattr(c, "__slots__", ()) if hasattr(o, s)]


NOT_HOST = (torch.Tensor, np.ndarray, ctypes.CDLL, ctypes._SimpleCData, ctypes.Array, ctypes._Pointer,
            ctypes.Structure)


@pytest.mark.parametrize("keygen_engine", ["device", "host"])
def test_saved_key_holds_host_values_only(store, monkeypatch, keygen_engine):
    """Proofs on the cpu under the device engine and the host engine attach
    every process cache; the file holds none of them, no tensor and no
    native object (a key made under the host engine keeps its polys' bytes
    in memory, not in the file), and the caches stay attached in memory."""
    params = Params.new(5, device="cpu")
    monkeypatch.setenv("BZ_PROOF_ENGINE", keygen_engine)
    pk = keygen(params, MulCircuit(1, 1, 1))
    made_natively = any(getattr(p, "bytes_arr", None) is not None for p in pk.fixed_polys)
    assert made_natively == (keygen_engine == "host")
    for engine in ("device", "host"):
        monkeypatch.setenv("BZ_PROOF_ENGINE", engine)
        proof = create_proof(params, pk, MulCircuit(3, 5, 15), [[15]], random.Random(GOLDEN["seed"]))
        assert proof.hex() == GOLDEN["proof_hex"]
    before = {name: pk.vk.__dict__[name] for name in VK_PROCESS_CACHES}
    assert all(name in pk.__dict__ for name in PK_PROCESS_CACHES)
    pk.save(store / "pk.pkl")
    raw = pickle.loads((store / "pk.pkl").read_bytes())
    bad = [type(o).__name__ for o in _graph(raw) if isinstance(o, NOT_HOST)]
    assert not bad, f"the saved key holds {sorted(set(bad))}"
    assert not any(name in raw.vk.__dict__ for name in VK_PROCESS_CACHES)
    assert not any(name in raw.__dict__ for name in PK_PROCESS_CACHES)
    assert all(pk.vk.__dict__[name] is before[name] for name in VK_PROCESS_CACHES)
    assert all(name in pk.__dict__ for name in PK_PROCESS_CACHES)
    assert made_natively == any(getattr(p, "bytes_arr", None) is not None for p in pk.fixed_polys)
    assert raw.fixed_polys == pk.fixed_polys and raw.vk.permutation.sigma_polys == pk.vk.permutation.sigma_polys
    assert list(store.iterdir()) == [store / "pk.pkl"]  # no temporary file left


def test_loaded_key_proves_golden_and_jax_bytes(store):
    params = cached_params(5, "cpu")
    mul_pk(params)
    artifacts.forget()
    params, pk = cached_params(5, "cpu"), mul_pk(cached_params(5, "cpu"))
    assert "_quotient_evaluators" not in pk.vk.__dict__  # a fresh key, loaded from the file
    proof = create_proof(params, pk, MulCircuit(3, 5, 15), [[15]], random.Random(GOLDEN["seed"]))
    assert proof.hex() == GOLDEN["proof_hex"]
    ref_params = RefParams.new(5)
    ref_pk = ref_keygen(ref_params, RefMulCircuit(1, 1, 1))
    assert proof == ref_create_proof(ref_params, ref_pk, RefMulCircuit(3, 5, 15), [[15]], random.Random(GOLDEN["seed"]))
    assert verify_proof(params, pk.vk, proof, [[15]])


def test_second_lookup_loads_and_derives_nothing(store, monkeypatch):
    params = cached_params(5, "cpu")
    pk = mul_pk(params)
    files = store_files(store)
    assert len(files) == 2
    artifacts.forget()

    def refuse(*args, **kwargs):
        raise AssertionError("derived again instead of loading the file")

    monkeypatch.setattr(hashtocurve, "hash_to_curve", refuse)
    monkeypatch.setattr(api, "keygen", refuse)
    loads = []
    monkeypatch.setattr(Params, "load", staticmethod(lambda *a, _load=Params.load: loads.append(a) or _load(*a)))
    again = cached_params(5, "cpu")
    other = cached_params(5, "cpu:0")  # a second device reads no file: the host values are bound to it
    assert len(loads) == 1
    assert (again.g, again.u, again.w) == (params.g, params.u, params.w) and other.g is again.g
    assert str(other.device) != str(again.device)
    loaded = mul_pk(again)
    assert loaded is mul_pk(other) and loaded is not pk
    assert loaded.vk.digest == pk.vk.digest and loaded.fixed_polys == pk.fixed_polys
    assert {p.name: p.stat().st_mtime_ns for p in files.values()} == {
        p.name: p.stat().st_mtime_ns for p in store_files(store).values()}


@pytest.mark.parametrize("fault", ["srs: not JSON", "srs: another k", "pk: truncated", "pk: wrong digest"])
def test_corrupt_file_is_reported_and_rebuilt(store, capsys, fault):
    params = cached_params(5, "cpu")
    pk = mul_pk(params)
    files = store_files(store)
    srs = next(p for name, p in files.items() if name.startswith("srs"))
    key = next(p for name, p in files.items() if name.startswith("pk"))
    if fault == "srs: not JSON":
        srs.write_text("{not json")
    elif fault == "srs: another k":
        Params.new(4, device="cpu").save(srs)
    elif fault == "pk: truncated":
        key.write_bytes(key.read_bytes()[:100])
    else:
        bad = ProvingKey.load(key)
        bad.vk.digest ^= 1
        key.write_bytes(pickle.dumps(bad))
    artifacts.forget()
    capsys.readouterr()
    again = cached_params(5, "cpu")
    loaded = mul_pk(again)
    err = capsys.readouterr().err.strip().splitlines()
    broken = srs if fault.startswith("srs") else key
    assert len(err) == 1 and str(broken) in err[0] and "load failed, rebuilding" in err[0]
    assert (again.g, loaded.vk.digest) == (params.g, pk.vk.digest)
    assert Params.load(srs, "cpu").k == 5 and ProvingKey.load(key).vk.digest == pk.vk.digest  # rewritten


def test_failed_save_is_reported_and_the_value_kept(tmp_path, monkeypatch, capsys):
    (tmp_path / "blocked").write_text("a file where the store's parent directory should be")
    monkeypatch.setattr(artifacts, "directory", lambda: tmp_path / "blocked" / "torch")
    params = cached_params(4, "cpu")
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "save failed" in err[0]
    assert params.g == Params.new(4, device="cpu").g


def test_port_file_names_differ_from_the_jax_packages(store):
    mul_pk(cached_params(5, "cpu"))
    fixed_bases._save_zs("Probe", (1, 2), [3, 4])
    names = sorted(store_files(store))
    assert len(names) == 3 and not [n for n in names if JAX_NAMES.fullmatch(n)]


def test_default_home_is_the_ports_own():
    assert DEFAULT_HOME() == ROOT / ".artifacts" / "torch"  # beside, not in, the JAX package's .artifacts/


def test_fixed_base_cache_lives_in_the_store(store, capsys):
    fixed_bases._save_zs("Probe", (1, 2), [3, 4])
    assert fixed_bases._derived_zs("Probe", (1, 2)) == [3, 4]
    assert fixed_bases._derived_zs("Probe", (1, 3)) is None  # another generator: a miss, not an error
    cache = fixed_bases._zs_cache("Probe")
    assert cache.parent == store
    cache.write_text("{broken")
    assert fixed_bases._derived_zs("Probe", (1, 2)) is None
    err = capsys.readouterr().err
    assert str(cache) in err and "unreadable" in err
