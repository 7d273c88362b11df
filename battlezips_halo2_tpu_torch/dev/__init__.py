"""Dev harness: MockProver, structured diagnostics and the layout renderer,
copied from the reference's dev/ (host Python, no tensors)."""

from .failures import (
    CellNotAssigned,
    ConstraintNotSatisfied,
    ConstraintRef,
    FailureLocation,
    GateRef,
    InstanceMismatch,
    LookupFailure,
    Permutation,
    RegionRef,
    VerifyFailure,
)
from .layout import circuit_layout, circuit_layout_svg, print_circuit_layout
from .mock import MockProver

__all__ = [
    "MockProver",
    "circuit_layout",
    "circuit_layout_svg",
    "print_circuit_layout",
    "VerifyFailure",
    "CellNotAssigned",
    "ConstraintNotSatisfied",
    "ConstraintRef",
    "FailureLocation",
    "GateRef",
    "InstanceMismatch",
    "LookupFailure",
    "Permutation",
    "RegionRef",
]
