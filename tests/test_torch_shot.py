"""The port's shot circuit (k=11) under its MockProver against the JAX
package, on the CPU, and the port's layout renderer (dev/layout.py).

The valid shots of tests/test_shot_circuit.py pass; each negative vector
(non-boolean hit, wrong assertions, no or several shots, a tampered
commitment or public input) fails on the port exactly as on the JAX
MockProver: the same failure types, constraints, locations and strings;
the hit = 2 vector gives the reference's exact failure list. The layout
summary and SVG of the shot circuit equal the JAX package's. Exact
comparisons."""

import pytest

from battlezips_halo2_tpu.circuits import ShotCircuit as RefShotCircuit
from battlezips_halo2_tpu.dev import MockProver as RefMockProver
from battlezips_halo2_tpu.dev import circuit_layout as ref_circuit_layout
from battlezips_halo2_tpu.dev import circuit_layout_svg as ref_circuit_layout_svg
from battlezips_halo2_tpu.utils import BinaryValue as RefBinaryValue
from battlezips_halo2_tpu.utils import Board as RefBoard
from battlezips_halo2_tpu.utils import Deck as RefDeck
from battlezips_halo2_tpu.utils import serialize as ref_serialize
from battlezips_halo2_tpu_torch.circuits import ShotCircuit
from battlezips_halo2_tpu_torch.dev import (
    ConstraintNotSatisfied,
    MockProver,
    Permutation,
    circuit_layout,
    circuit_layout_svg,
    print_circuit_layout,
)
from battlezips_halo2_tpu_torch.fields.host import FP
from battlezips_halo2_tpu_torch.utils import BinaryValue, Board, Deck, serialize
from test_shot_circuit import BOARD_0, BOARD_1, TRAPDOOR

PORT = (MockProver, ShotCircuit, Board, Deck, BinaryValue, serialize)
REF = (RefMockProver, RefShotCircuit, RefBoard, RefDeck, RefBinaryValue, ref_serialize)


def _circuit(package, placements, shot, hit):
    _, circuit_cls, board_cls, deck_cls, value_cls, ser = package
    board = board_cls.from_deck(deck_cls.from_placements(placements))
    xs, ys = shot
    shot_value = ser(list(xs), list(ys)) if xs else value_cls.empty()
    return circuit_cls(board.state(), TRAPDOOR, shot_value, value_cls(hit))


def _run(package, placements, shot, hit, tamper=None):
    """One shot through a package's MockProver at k=11, as
    tests/test_shot_circuit.py::run_shot does; ``tamper`` adds 1 (or
    subtracts 1 for index 3) to one public input."""
    circuit = _circuit(package, placements, shot, hit)
    instance = list(circuit.public_instance())
    if tamper is not None:
        instance[tamper] = (instance[tamper] + (-1 if tamper == 3 else 1)) % FP.modulus
    return package[0].run(11, circuit, [instance]).verify()


VALID = {
    "hit_0": (BOARD_0, ([3], [3]), 1),
    "hit_1": (BOARD_1, ([3], [4]), 1),
    "miss_0": (BOARD_0, ([9], [9]), 0),
    "miss_1": (BOARD_1, ([0], [9]), 0),
}
# (placements, (shot xs, shot ys), hit, tampered public input): the negative
# vectors of tests/test_shot_circuit.py
INVALID = {
    "non_boolean_hit_assertion": (BOARD_0, ([3], [3]), 2, None),
    "assert_hit_when_miss": (BOARD_0, ([9], [9]), 1, None),
    "assert_miss_when_hit": (BOARD_0, ([3], [3]), 0, None),
    "no_shot": (BOARD_0, ([], []), 0, None),
    "multi_shot": (BOARD_0, ([9, 8], [9, 9]), 0, None),
    "multi_hit": (BOARD_0, ([3, 3], [3, 4]), 1, None),
    "commitment": (BOARD_1, ([0], [0]), 1, 0),
    "public_board_commitment": (BOARD_0, ([0], [0]), 0, 1),
    "public_shot_commitment": (BOARD_0, ([0], [0]), 0, 2),
    "public_hit_assertion": (BOARD_0, ([3], [3]), 1, 3),
}


@pytest.mark.parametrize("case", sorted(VALID))
def test_mock_prover_accepts_valid_shots(case):
    assert _run(PORT, *VALID[case]) == []


@pytest.mark.parametrize("case", sorted(INVALID))
def test_mock_prover_failures_match_jax(case):
    got = _run(PORT, *INVALID[case])
    want = _run(REF, *INVALID[case])
    assert got
    assert [type(f).__name__ for f in got] == [type(f).__name__ for f in want]
    assert [str(f) for f in got] == [str(f) for f in want]
    assert all(isinstance(f, (ConstraintNotSatisfied, Permutation)) for f in got)
    if INVALID[case][3] is not None:  # a tampered public input breaks only the copy constraints
        assert all(isinstance(f, Permutation) for f in got)


def test_exact_failure_vector_non_boolean_hit():
    """hit = 2 on BOARD_1 at (9, 8): the booleanity failure (region 0,
    offset 4) and the output failure (region 4, offset 0), in that order,
    with the reference's names and cell values."""
    got = _run(PORT, BOARD_1, ([9], [8]), 2)
    assert [(f.constraint.gate.name, f.constraint.name, f.location.region.name, f.location.offset) for f in got] == [
        ("boolean hit assertion", "asserted hit value is boolean", "load private ShotChip advice values", 4),
        ("constrain shot running sum output", "Public hit assertion matches private witness",
         "shot running sum output checks", 0),
    ]
    assert [str(f) for f in got] == [str(f) for f in _run(REF, BOARD_1, ([9], [8]), 2)]


def test_layout_matches_jax(capsys):
    """dev/layout.py renders the shot circuit's layout as the JAX package
    does, as text and as SVG."""
    circuit = _circuit(PORT, BOARD_0, ([3], [3]), 1)
    ref = _circuit(REF, BOARD_0, ([3], [3]), 1)
    text = circuit_layout(circuit, 11)
    assert text == ref_circuit_layout(ref, 11) and "region" in text.lower()
    assert circuit_layout_svg(circuit, 11) == ref_circuit_layout_svg(ref, 11)
    print_circuit_layout(circuit, 11)
    assert capsys.readouterr().out.strip() == text.strip()
