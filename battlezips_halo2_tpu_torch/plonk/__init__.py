"""PLONKish proving system: constraint system, synthesis runtime, keygen,
prover, verifier."""

from .assignment import AssignedCell, Assignment, Layouter, Region, Table
from .circuit import ConstraintSystem, Gate, Lookup, TableColumn
from .expression import Column, ColumnType, Constant, Expression, Selector


class Circuit:
    """Base circuit protocol (halo2 ``Circuit`` trait analog).

    Subclasses implement:
    * ``configure(cls, cs) -> Config`` (classmethod/staticmethod)
    * ``synthesize(self, config, layouter)``
    * ``without_witnesses(self) -> Circuit`` — same shape, dummy witness
      (used by keygen; reference analog src/circuits/board.rs:26-28).
    """

    @classmethod
    def configure(cls, cs: ConstraintSystem):
        raise NotImplementedError

    def synthesize(self, config, layouter: Layouter):
        raise NotImplementedError

    def without_witnesses(self) -> "Circuit":
        raise NotImplementedError


def keygen(params, circuit):
    """Build pk (and embedded vk) — lazy import (plonk.keys pulls in the
    pcs/ops stack; the submodule is named `keys`, not `keygen`, so this
    function binding can never be shadowed by a submodule import)."""
    from .keys import keygen as _impl

    return _impl(params, circuit)


def create_proof(params, pk, circuit, instances, rng):
    """Full prover pipeline — lazy import (plonk.prover pulls in pcs/ops)."""
    from .prover import create_proof as _impl

    return _impl(params, pk, circuit, instances, rng)


def create_proofs_batched(params, pk, circuits, instances_list, rngs, engine=None):
    """Batch prover, B proofs under one key phase by phase, each
    bit-identical to create_proof — lazy import (plonk.batch_prover pulls
    in pcs/ops)."""
    from .batch_prover import create_proofs_batched as _impl

    return _impl(params, pk, circuits, instances_list, rngs, engine)


def verify_proof(params, vk, proof, instances):
    """Verifier — lazy import (plonk.verifier pulls in pcs/ops)."""
    from .verifier import verify_proof as _impl

    return _impl(params, vk, proof, instances)


__all__ = [
    "keygen",
    "create_proof",
    "create_proofs_batched",
    "verify_proof",
    "AssignedCell",
    "Assignment",
    "Circuit",
    "Column",
    "ColumnType",
    "Constant",
    "ConstraintSystem",
    "Expression",
    "Gate",
    "Layouter",
    "Lookup",
    "Region",
    "Selector",
    "Table",
    "TableColumn",
]
