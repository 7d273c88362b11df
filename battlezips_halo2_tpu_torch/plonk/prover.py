"""The PLONK prover of one proof, and the host helpers its phases share.

Framework analog of ``halo2_proofs::plonk::create_proof``: witness
synthesis -> blinded advice commitments -> lookup permute + product ->
permutation grand products (chunked) -> vanishing argument (quotient over
the extended coset) -> evaluations at the challenge point -> multiopen ->
final IPA argument. One proof is a batch of one through
plonk/batch_prover.py, which holds the phases: the same transcript, rng
draws and device work, so a proof is bit-identical to the reference's for
the same keys and rng, alone or in a batch. The batch of one runs on the
engine ops/engine.py picks for the domain (BZ_PROOF_ENGINE): the card's
kernels, or the native host engine.
"""

from __future__ import annotations

import threading

import numpy as np

from .. import native
from ..fields.host import FP
from ..pcs.ipa import Params
from .circuit import ConstraintSystem
from .keys import ProvingKey

P = FP.modulus


def _obj_array(values: list[int]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v % P
    return out


_evaluator_lock = threading.Lock()


def _get_native_quotient_evaluator(vk, schedule):
    """The native host engine's quotient evaluator (ops/native_quotient.py),
    one per verifying key, cached on it (keys from keygen or convert.py)."""
    ev = vk.__dict__.get("_native_quotient_evaluator")
    if ev is None:
        with _evaluator_lock:
            ev = vk.__dict__.get("_native_quotient_evaluator")
            if ev is None:
                from ..ops.native_quotient import NativeQuotientEvaluator

                ev = vk._native_quotient_evaluator = NativeQuotientEvaluator(vk, schedule)
    return ev


def _grand_product_prefix(nums, dens, carry: int, host: bool) -> list[int]:
    """z[0] = carry, z[i+1] = z[i] * nums[i] / dens[i] over the usable rows;
    on the native host engine (one batch inversion and a prefix product)
    if ``host``."""
    if host:
        nb = native.ints_to_bytes_arr([int(v) % P for v in nums])
        db = native.ints_to_bytes_arr([int(v) % P for v in dens])
        return native.bytes_arr_to_ints(native.grand_product(native.which_for(P), nb, db, carry % P))
    den_inv = FP.batch_inv([int(v) for v in dens])
    z = [0] * (len(nums) + 1)
    z[0] = carry
    acc = carry
    for i in range(len(nums)):
        acc = acc * int(nums[i]) % P * den_inv[i] % P
        z[i + 1] = acc
    return z


def create_proof(
    params: Params,
    pk: ProvingKey,
    circuit,
    instances: list[list[int]],
    rng,
) -> bytes:
    """Prove ``circuit`` with public input ``instances`` and blinding
    randomness ``rng``: a batch of one on the engine that ops/engine.py
    picks for the domain (BZ_PROOF_ENGINE; the device engine by default),
    whatever ``BZ_BATCH_ENGINE`` says."""
    from ..ops.engine import use_host_engine
    from .batch_prover import create_proofs_batched

    engine = "host" if use_host_engine(params.n) else "device"
    return create_proofs_batched(params, pk, [circuit], [instances], [rng], engine=engine)[0]


_config_cache: dict = {}


def _configure_cached(cs: ConstraintSystem, circuit):
    """The prover must synthesize against the SAME ConstraintSystem the pk
    was built with; re-run configure on a throwaway CS to get a config object
    bound to equivalent columns (deterministic configure makes them match).
    Keyed by circuit type alone: configure() is a pure function of the type,
    and keying by id(cs) would risk stale hits after the id is recycled."""
    key = type(circuit)
    if key not in _config_cache:
        probe = ConstraintSystem()
        config = key.configure(probe)
        _config_cache[key] = config
    return _config_cache[key]
