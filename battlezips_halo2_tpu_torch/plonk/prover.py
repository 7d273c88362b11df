"""The PLONK prover of one proof, and the host helpers its phases share.

Framework analog of ``halo2_proofs::plonk::create_proof``: witness
synthesis -> blinded advice commitments -> lookup permute + product ->
permutation grand products (chunked) -> vanishing argument (quotient over
the extended coset) -> evaluations at the challenge point -> multiopen ->
final IPA argument. One proof is a batch of one through
plonk/batch_prover.py, which holds the phases: the same transcript, rng
draws and device work, so a proof is bit-identical to the reference's for
the same keys and rng, alone or in a batch.
"""

from __future__ import annotations

import numpy as np

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


def _grand_product_prefix(nums, dens, carry: int) -> list[int]:
    """z[0] = carry, z[i+1] = z[i] * nums[i] / dens[i] over the usable rows."""
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
    randomness ``rng``: a batch of one on the device engine, whatever
    ``BZ_BATCH_ENGINE`` says."""
    from .batch_prover import create_proofs_batched

    return create_proofs_batched(params, pk, [circuit], [instances], [rng], engine="device")[0]


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
