"""Key generation: proving/verifying keys from a circuit.

Framework analog of ``halo2_proofs::plonk::{keygen_vk, keygen_pk}``
(SURVEY.md §2.2 "PLONKish constraint system + keygen"): runs a witness-free
synthesis to collect fixed columns, selector activations and the equality
permutation, builds the sigma polynomials (delta^j * omega^i cell encoding),
and commits all fixed/sigma polynomials into the verifying key. Selectors
become extra fixed columns, combined by plonk/compress.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from ..fields.host import FP
from ..pcs.ipa import Params, commit_many
from ..poly.domain import EvaluationDomain
from .assignment import Assignment, Layouter
from .circuit import ConstraintSystem
from .expression import Column, ColumnType

# delta: generator of the order-(p-1)/2^32 subgroup — coset separator for
# permutation cell encodings (disjoint from the omega subgroup cosets)
DELTA = pow(FP.generator, 1 << FP.two_adicity, FP.modulus)


@dataclass
class PermutationData:
    columns: list  # equality-enabled columns, in declaration order
    sigmas: list  # per column: length-n list of encoded image values
    sigma_polys: list  # coeff form
    sigma_commitments: list

    def __getstate__(self):
        return {**self.__dict__, "sigma_polys": _plain(self.sigma_polys)}


@dataclass
class VerifyingKey:
    k: int
    cs: ConstraintSystem
    domain: EvaluationDomain
    fixed_commitments: list  # num_fixed + num_selectors commitments
    permutation: PermutationData
    digest: int = 0

    def compute_digest(self):
        """halo2 0.2.0 hash_into semantics: blake2b-512 (person
        "Halo2-Verify-Key") over the Rust {:?} text of the pinned vk,
        length-prefixed, wide-reduced — see plonk/pinned.py. Seeded into
        every transcript as a common scalar (matches the reference's
        keygen_vk/verify_proof usage, src/circuits/board.rs:909-912)."""
        from .pinned import vk_transcript_repr

        self.digest = vk_transcript_repr(self)
        return self.digest

    def __getstate__(self):
        return _without(self.__dict__, VK_PROCESS_CACHES)


# Caches the prover attaches to a key for the life of a process; they hold
# tensors on a card or native handles, and a pickled key leaves them out.
VK_PROCESS_CACHES = ("_native_quotient_evaluator", "_quotient_evaluators")  # plonk/prover.py, batch_prover.py
PK_PROCESS_CACHES = ("_native_wrapped",)  # plonk/batch_prover.py


def _without(state: dict, names: tuple) -> dict:
    return {k: v for k, v in state.items() if k not in names}


def _plain(polys: list) -> list:
    """Plain int lists: a poly from a native route (poly/polyints.py's
    PolyInts) also carries its bytes, which a pickled key leaves out."""
    return [list(p) for p in polys]


PK_SCHEMA = 1  # the pickled layout of ProvingKey / VerifyingKey / ConstraintSystem


@dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_values: list  # per fixed column (incl selectors): length-n ints
    fixed_polys: list  # coeff form

    def __getstate__(self):
        return {**_without(self.__dict__, PK_PROCESS_CACHES), "fixed_polys": _plain(self.fixed_polys)}

    # --- persistence (the artifact store, artifacts.py) -------------------
    def save(self, path) -> None:
        """Pickle the key's host values (ints, lists, the constraint
        system) through a temporary name and a rename; the process caches
        stay attached in memory and stay out of the file."""
        import pickle

        from .. import artifacts

        artifacts.write_atomic(Path(path), pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL))

    @staticmethod
    def load(path) -> "ProvingKey":
        """A key written by :meth:`save`. Raises ValueError unless the
        file holds a ProvingKey whose vk digest, recomputed, is the stored
        one. Only files this package wrote are to be loaded: unpickling
        runs code."""
        import pickle

        pk = pickle.loads(Path(path).read_bytes())
        if not isinstance(pk, ProvingKey):
            raise ValueError(f"{path} holds a {type(pk).__name__}, not a ProvingKey")
        stored = pk.vk.digest
        if pk.vk.compute_digest() != stored:
            raise ValueError(f"{path}: the vk digest does not match the stored one")
        return pk


def num_fixed_total(cs: ConstraintSystem) -> int:
    """Fixed columns incl. the appended selector columns (combined columns
    after selector compression, raw 0/1 columns before)."""
    return cs.num_fixed + getattr(cs, "num_selector_columns", len(cs.selectors))


def fixed_column_index(cs: ConstraintSystem, column: Column) -> int:
    """Index into the combined fixed-column array (selectors appended)."""
    assert column.kind == ColumnType.FIXED
    return column.index


def selector_column_index(cs: ConstraintSystem, sel_index: int) -> int:
    return cs.num_fixed + sel_index


def build_permutation(cs: ConstraintSystem, assignment: Assignment, n: int) -> tuple[list, list]:
    """Union-find over copy constraints -> per-column sigma value lists."""
    columns = list(cs.equality_columns)
    col_pos = {c: j for j, c in enumerate(columns)}

    parent: dict = {}

    def find(cell):
        while parent.get(cell, cell) != cell:
            parent[cell] = parent.get(parent[cell], parent[cell])
            cell = parent[cell]
        return cell

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for left, right in assignment.copies:
        union(left, right)

    groups: dict = {}
    for cell in list(parent.keys()):
        groups.setdefault(find(cell), []).append(cell)
    # include roots themselves
    for root in list(groups.keys()):
        if root not in groups[root]:
            groups[root].append(root)

    # identity mapping by default: sigma(col j, row i) = delta^j * omega^i
    m = FP.modulus
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * _omega_for(n) % m
    delta_pows = [pow(DELTA, j, m) for j in range(len(columns))]

    def encode(col_j, row_i):
        return delta_pows[col_j] * omega_pows[row_i] % m

    sigmas = [[encode(j, i) for i in range(n)] for j in range(len(columns))]

    for cells in groups.values():
        # cyclic shift within the group
        cells = sorted(set(cells), key=lambda c: (col_pos[c[0]], c[1]))
        for idx, cell in enumerate(cells):
            nxt = cells[(idx + 1) % len(cells)]
            j, i = col_pos[cell[0]], cell[1]
            sigmas[j][i] = encode(col_pos[nxt[0]], nxt[1])
    return columns, sigmas


_omega_cache: dict = {}


def _omega_for(n: int) -> int:
    if n not in _omega_cache:
        k = n.bit_length() - 1
        _omega_cache[n] = pow(FP.root_of_unity, 1 << (FP.two_adicity - k), FP.modulus)
    return _omega_cache[n]


def synthesize_keys_layout(circuit, k: int):
    """Witness-free synthesis of a circuit: -> (constraint system with its
    selectors compressed, fixed column values incl. the selector columns,
    assignment, quotient degree before compression)."""
    from ..config import config as _config

    template = circuit.without_witnesses()
    cs = ConstraintSystem()
    config = type(template).configure(cs)
    n = 1 << k
    # quotient degree from the PRE-compression system; compression groups
    # are capped so rewritten constraints never exceed it
    pre_degree = cs.degree()

    assignment = Assignment(cs, n)
    layouter = Layouter(assignment)
    template.synthesize(config, layouter)
    layouter.finalize()

    fixed_values = []
    for col in assignment.fixed:
        fixed_values.append([0 if v is None else v % FP.modulus for v in col])
    if not _config().selector_compression:
        cs.num_selector_columns = len(cs.selectors)
        cs.selector_assignments = {}
        for sel in assignment.selectors:
            fixed_values.append([1 if b else 0 for b in sel])
    else:
        from .compress import compress_selectors

        fixed_values += compress_selectors(cs, assignment.selectors, n)
    return cs, fixed_values, assignment, pre_degree


def keygen(params: Params, circuit) -> ProvingKey:
    """Build pk (and embedded vk) for a circuit instance (uses
    without_witnesses() so witness values never matter); transforms and
    commitments run on ``params.device``."""
    from ..poly.transforms import batch_lagrange_to_coeff

    k, n = params.k, params.n
    cs, fixed_values, assignment, pre_degree = synthesize_keys_layout(circuit, k)
    domain = EvaluationDomain(k, pre_degree)
    fixed_polys = batch_lagrange_to_coeff(domain, fixed_values, params.device)
    columns, sigmas = build_permutation(cs, assignment, n)
    sigma_polys = batch_lagrange_to_coeff(domain, sigmas, params.device)
    all_commitments = commit_many(
        params, fixed_polys + sigma_polys, [0] * (len(fixed_polys) + len(sigma_polys))
    )
    fixed_commitments = all_commitments[: len(fixed_polys)]
    sigma_commitments = all_commitments[len(fixed_polys) :]

    vk = VerifyingKey(
        k=k,
        cs=cs,
        domain=domain,
        fixed_commitments=fixed_commitments,
        permutation=PermutationData(columns, sigmas, sigma_polys, sigma_commitments),
    )
    vk.compute_digest()
    return ProvingKey(vk=vk, fixed_values=fixed_values, fixed_polys=fixed_polys)
