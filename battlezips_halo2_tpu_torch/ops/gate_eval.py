"""Quotient (gate / permutation / lookup) evaluation on device.

The prover's heaviest phase evaluates every constraint polynomial over the
extended coset and folds the terms with y. The constraint math is emitted
as bytecode (``_VMEmitter``): the gate / permutation / lookup formulas are
walked once into a static stream of field ops (mul / add / sub) over a
register file of (ext, 8)-limb Montgomery vectors. The executor is a Python
loop over that stream; each instruction is one launch of kernel K1
(fields/limb.py::field_op) writing its destination register in place.

* inputs (extended column polys with their rotations, challenges,
  constants) are bound to pinned registers per call; temporaries are
  register-allocated with a free list at emission time;
* l_0 / l_last / l_active, the coset coordinates and 1/Z_H are constants
  of the proving key;
* the division by Z_H, the extended iNTT and the coset unscale run in the
  same pass; input: coefficient polys, output: h coefficients.

All ops are exact field ops, and the emission follows the same formula and
fold order as plonk/arguments.py, so the quotient is bit-identical to the
reference's. ``BatchQuotientEvaluator`` runs the program once for a batch
of proofs under one key (plonk/batch_prover.py; a single proof is a batch
of one).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import limb as L
from ..fields.host import FP
from ..fields.limb import FP_SPEC, ints_to_limbs, limbs_to_ints
from ..plonk.arguments import ProofSchedule
from ..plonk.expression import ColumnType
from ..plonk.keys import DELTA, selector_column_index
from ..poly.transforms import coeff_to_extended_limbs, extended_to_coeff_limbs

P = FP.modulus

OP_MUL, OP_ADD, OP_SUB = 0, 1, 2


class _Handle:
    __slots__ = ("kind", "id", "kept")

    def __init__(self, kind: str, hid: int, kept: bool = False):
        self.kind = kind  # "agg" | "pin" | "temp"
        self.id = hid
        self.kept = kept


class _VMEmitter:
    """Records field-op instructions over register handles.

    Temp registers are freed the first time they are consumed (expression
    trees use each intermediate exactly once); call ``keep(h)`` for the
    rare value used more than once and ``drop(h)`` when done with it."""

    def __init__(self):
        self.pins: dict = {}
        self.pin_keys: list = []
        self.prog: list = []  # (op, handle, handle, dst_handle-snapshot)
        self._free: list = []
        self._next_temp = 0

    # --- pinned inputs ----------------------------------------------------
    def _pin(self, key) -> _Handle:
        if key not in self.pins:
            self.pins[key] = len(self.pin_keys)
            self.pin_keys.append(key)
        return _Handle("pin", self.pins[key])

    def inp(self, kind: str, index: int, rot: int = 0) -> _Handle:
        return self._pin(("inp", kind, index, rot))

    def const_int(self, v: int) -> _Handle:
        return self._pin(("const", v % P))

    def chal(self, name: str) -> _Handle:
        return self._pin(("chal", name))

    def named(self, name: str) -> _Handle:
        return self._pin(("named", name))

    def agg(self) -> _Handle:
        return _Handle("agg", 0)

    # --- ops --------------------------------------------------------------
    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        t = self._next_temp
        self._next_temp += 1
        return t

    def _release(self, h: _Handle):
        if h.kind == "temp" and not h.kept:
            self._free.append(h.id)

    def _emit(self, op: int, a: _Handle, b: _Handle) -> _Handle:
        self._release(a)
        if b is not a:
            self._release(b)
        dst = _Handle("temp", self._alloc())
        self.prog.append((op, (a.kind, a.id), (b.kind, b.id), (dst.kind, dst.id)))
        return dst

    def mul(self, a, b):
        return self._emit(OP_MUL, a, b)

    def add(self, a, b):
        return self._emit(OP_ADD, a, b)

    def sub(self, a, b):
        return self._emit(OP_SUB, a, b)

    def neg(self, a):
        return self._emit(OP_SUB, self.const_int(0), a)

    def keep(self, h: _Handle) -> _Handle:
        h.kept = True
        return h

    def drop(self, h: _Handle):
        if h.kind == "temp":
            h.kept = False
            self._free.append(h.id)

    def fold_term(self, t: _Handle):
        """agg = agg * y + t (t consumed)."""
        a = self.agg()
        self.prog.append((OP_MUL, ("agg", 0), ("pin", self.pins[("chal", "y")]), ("agg", 0)))
        self._release(t)
        self.prog.append((OP_ADD, ("agg", 0), (t.kind, t.id), ("agg", 0)))

    # --- finalize ---------------------------------------------------------
    def finalize(self) -> tuple[np.ndarray, list, int]:
        """-> ((I, 4) int32 program, pin keys, total registers).
        Register layout: [0]=agg, [1..n_pins]=pins, then temps."""
        n_pins = len(self.pin_keys)

        def reg(kind, hid):
            if kind == "agg":
                return 0
            if kind == "pin":
                return 1 + hid
            return 1 + n_pins + hid

        prog = np.array(
            [(op, reg(*a), reg(*b), reg(*d)) for op, a, b, d in self.prog],
            dtype=np.int32,
        )
        return prog, self.pin_keys, 1 + n_pins + self._next_temp


def quotient_poly_keys(cs, num_perm_chunks: int):
    """Canonical ordering of every polynomial the quotient evaluation reads;
    the prover stacks its coefficient polys in exactly this order."""
    keys = []
    keys += [("advice", i) for i in range(cs.num_advice)]
    from ..plonk.keys import num_fixed_total

    keys += [("fixed", i) for i in range(num_fixed_total(cs))]
    keys += [("instance", i) for i in range(cs.num_instance)]
    keys += [("perm_z", i) for i in range(num_perm_chunks)]
    keys += [("sigma", i) for i in range(len(cs.equality_columns))]
    for i in range(len(cs.lookups)):
        keys += [("lk_a", i), ("lk_s", i), ("lk_z", i)]
    return keys


def _emit_constraints(em: _VMEmitter, cs, usable: int, chunk_meta, lookups, gates):
    """Walk every constraint term through the emitter, folding with y in the
    SAME order as the host path (plonk/arguments.py) so the quotient is
    bit-identical."""

    def eval_expr(expr):
        return expr.evaluate(
            constant=lambda v: em.const_int(v),
            cell=lambda column, rot: em.inp(
                "advice"
                if column.kind == ColumnType.ADVICE
                else ("fixed" if column.kind == ColumnType.FIXED else "instance"),
                column.index,
                rot,
            ),
            selector=lambda s: em.inp("fixed", selector_column_index(cs, s.index)),
            add=em.add,
            mul=em.mul,
            neg=em.neg,
        )

    one = em.named("one")
    l0 = em.named("l0")
    llast = em.named("llast")
    lactive = em.named("lactive")
    x = em.named("x")
    theta, beta, gamma = em.chal("theta"), em.chal("beta"), em.chal("gamma")
    em.chal("y")  # ensure the fold challenge is pinned

    for gate in gates:
        for _, poly in gate.constraints:
            em.fold_term(eval_expr(poly))

    # --- permutation terms (same order as arguments.permutation_terms) ----
    if chunk_meta:
        n_chunks = len(chunk_meta)
        z = lambda c: em.inp("perm_z", c)
        em.fold_term(em.mul(l0, em.sub(one, z(0))))
        zl = z(n_chunks - 1)
        em.fold_term(em.mul(llast, em.sub(em.mul(zl, zl), zl)))
        for c in range(1, n_chunks):
            prev_last = em.inp("perm_z", c - 1, usable)
            em.fold_term(em.mul(l0, em.sub(z(c), prev_last)))
        for c, entries in enumerate(chunk_meta):
            # left/right accumulate across the loop: keep while live, clear
            # kept on the final use so em.sub releases them exactly once
            left = em.inp("perm_z", c, 1)
            right = z(c)
            for kind, idx, j, delta_j in entries:
                v = em.inp(kind, idx)
                sigma = em.inp("sigma", j)
                lf = em.add(v, em.add(em.mul(beta, sigma), gamma))
                left.kept = False  # released by this use
                left = em.keep(em.mul(left, lf))
                bx = em.mul(em.mul(beta, em.const_int(delta_j)), x)
                rf = em.add(v, em.add(bx, gamma))
                right.kept = False
                right = em.keep(em.mul(right, rf))
            left.kept = right.kept = False
            em.fold_term(em.mul(em.sub(left, right), lactive))

    # --- lookup terms (same order as arguments.lookup_terms) --------------
    for li, lk in enumerate(lookups):
        a_comp = None
        s_comp = None
        for i_expr, t_expr in lk.mapping:
            iv = eval_expr(i_expr)
            tv = eval_expr(t_expr)
            if a_comp is None:
                a_comp = em.keep(iv)
                s_comp = em.keep(tv)
            else:
                a_comp.kept = False
                a_comp = em.keep(em.add(em.mul(a_comp, theta), iv))
                s_comp.kept = False
                s_comp = em.keep(em.add(em.mul(s_comp, theta), tv))
        zr = em.inp("lk_z", li)
        z_next = em.inp("lk_z", li, 1)
        a_perm = em.inp("lk_a", li)
        s_perm = em.inp("lk_s", li)
        a_prev = em.inp("lk_a", li, -1)
        em.fold_term(em.mul(l0, em.sub(one, zr)))
        em.fold_term(em.mul(llast, em.sub(em.mul(zr, zr), zr)))
        lhs = em.mul(em.mul(z_next, em.add(a_perm, beta)), em.add(s_perm, gamma))
        a_comp.kept = False
        s_comp.kept = False
        rhs = em.mul(em.mul(zr, em.add(a_comp, beta)), em.add(s_comp, gamma))
        em.fold_term(em.mul(em.sub(lhs, rhs), lactive))
        diff = em.keep(em.sub(a_perm, s_perm))
        em.fold_term(em.mul(l0, diff))
        diff.kept = False
        em.fold_term(em.mul(em.mul(diff, em.sub(a_perm, a_prev)), lactive))


def quotient_constants(vk) -> dict:
    """Per-pk quotient constants as int lists over the extended coset:
    l0 / llast / lactive Lagrange selectors, the coset x coordinates and
    1/Z_H."""
    from ..plonk.arguments import _lagrange_basis_extended

    cs = vk.cs
    domain = vk.domain
    usable = cs.usable_rows(domain.n)
    ext = domain.extended_n
    rows = [0, usable] + list(range(usable + 1, domain.n))
    basis = _lagrange_basis_extended(domain, rows)
    l0 = [int(v) for v in basis[0]]
    llast = [int(v) for v in basis[usable]]
    blind = np.zeros(ext, dtype=object)
    for i in range(usable + 1, domain.n):
        blind = (blind + basis[i]) % P
    lactive = [(1 - (lv + bv)) % P for lv, bv in zip(llast, blind)]
    xs = []
    acc = domain.g_coset
    for _ in range(ext):
        xs.append(acc)
        acc = acc * domain.extended_omega % P
    t_inv = FP.batch_inv(domain.t_extended())
    return {"l0": l0, "llast": llast, "lactive": lactive, "x": xs, "t_inv": t_inv}


def emit_vm(vk, schedule: ProofSchedule):
    """Emit the constraint bytecode for a verifying key: -> ((I, 4) int32
    program, pin keys, total registers), the same stream as the reference's
    device and native executors run."""
    cs = vk.cs
    usable = cs.usable_rows(vk.domain.n)
    perm_cols = vk.permutation.columns
    chunk_len = schedule.chunk_len
    chunk_meta = []
    for c0 in range(0, len(perm_cols), chunk_len):
        cols = perm_cols[c0 : c0 + chunk_len]
        entries = []
        for col in cols:
            j = perm_cols.index(col)
            entries.append((col.kind.value, col.index, j, pow(DELTA, j, P)))
        chunk_meta.append(entries)
    em = _VMEmitter()
    _emit_constraints(em, cs, usable, chunk_meta, cs.lookups, cs.gates)
    return em.finalize()


class BatchQuotientEvaluator:
    """Built once per proving key: the quotients of B proofs under that key,
    one VM program for the whole batch; __call__(list of polys by key, list
    of challenges) -> list of h coefficients.

    * the pk-constant polynomials (the ``fixed`` and ``sigma`` keys) are
      extended to the coset once, at the first call, and kept;
    * each proof's polynomials are uploaded as length-n coefficients and
      zero-padded to the extended size on the device;
    * the register file is (n_regs, B, ext, 8), so a register is one
      contiguous (B ext, 8) block and every VM instruction is one launch of
      kernel K1 for the whole batch; the challenge registers hold each
      proof's challenges along the B axis;
    * the program is the reference's instruction stream, so each proof's h
      coefficients are the reference's, bit for bit.
    """

    def __init__(self, vk, schedule: ProofSchedule, device):
        cs = vk.cs
        domain = vk.domain
        self.domain = domain
        self.device = torch.device(device)
        self.keys = quotient_poly_keys(cs, schedule.num_perm_chunks)
        self.shared_keys = [k for k in self.keys if k[0] in ("fixed", "sigma")]
        self.per_keys = [k for k in self.keys if k[0] not in ("fixed", "sigma")]
        self._shared_index = {k: i for i, k in enumerate(self.shared_keys)}
        self._per_index = {k: i for i, k in enumerate(self.per_keys)}
        self._shared_ext = None
        ext = domain.extended_n
        self.rot_scale = ext // domain.n
        r = FP_SPEC.r_mod_p

        consts = quotient_constants(vk)

        def mont_const(vals):
            return ints_to_limbs([v * r % P for v in vals], self.device)

        self.named = {name: mont_const(consts[name]) for name in ("l0", "llast", "lactive", "x")}
        self.named["one"] = FP_SPEC.const("one_mont", self.device).expand(ext, L.NLIMBS)
        self.t_inv = mont_const(consts["t_inv"])
        prog, self.pin_keys, self.n_regs = emit_vm(vk, schedule)
        self.prog = prog.tolist()
        self.vm_size = (len(self.prog), self.n_regs)

    def _extended(self, polys: list) -> torch.Tensor:
        """Coefficient lists (each <= n long) -> (K, ext, 8) Montgomery
        evaluations on the extended coset; the padding to ext is on the
        device (poly/transforms.py::coeff_to_extended_limbs)."""
        n = self.domain.n
        flat = []
        for poly in polys:
            flat.extend(v % P for v in poly)
            flat.extend([0] * (n - len(poly)))
        coeffs = ints_to_limbs(flat, self.device).reshape(len(polys), n, L.NLIMBS)
        return L.to_mont(FP_SPEC, coeff_to_extended_limbs(self.domain, coeffs))

    def __call__(self, coeff_polys_by_key_list: list, challenges_list: list) -> list[list[int]]:
        """coeff_polys_by_key_list: one {key: coefficient int list} per
        proof; challenges_list: one (theta, beta, gamma, y) per proof.
        Returns each proof's h coefficients."""
        nb = len(coeff_polys_by_key_list)
        if nb == 0 or nb != len(challenges_list):
            raise ValueError(f"need one challenge tuple per proof: {nb} proofs, {len(challenges_list)} tuples")
        ext = self.domain.extended_n
        dev = self.device
        if self._shared_ext is None:
            self._shared_ext = self._extended([coeff_polys_by_key_list[0][k] for k in self.shared_keys])
        per = self._extended([polys[k] for polys in coeff_polys_by_key_list for k in self.per_keys])
        per = per.view(nb, len(self.per_keys), ext, L.NLIMBS)
        flat_ch = [c % P for chs in challenges_list for c in chs]
        ch = L.to_mont(FP_SPEC, ints_to_limbs(flat_ch, dev)).view(nb, 4, 1, L.NLIMBS)
        chal = dict(zip(("theta", "beta", "gamma", "y"), ch.unbind(1)))

        def evals_of(key):
            if key in self._shared_index:
                return self._shared_ext[self._shared_index[key]]
            return per[:, self._per_index[key]]

        # register file: [0] = agg, [1 .. pins] = pinned inputs, then temps
        regs = torch.zeros((self.n_regs, nb, ext, L.NLIMBS), dtype=torch.int32, device=dev)
        for i, key in enumerate(self.pin_keys, start=1):
            if key[0] == "inp":
                _, kind, index, rot = key
                regs[i] = torch.roll(evals_of((kind, index)), -rot * self.rot_scale, -2)
            elif key[0] == "const":
                regs[i] = ints_to_limbs([key[1] * FP_SPEC.r_mod_p % P], dev)
            elif key[0] == "chal":
                regs[i] = chal[key[1]]
            else:
                regs[i] = self.named[key[1]]
        for op, a, b, d in self.prog:
            L.field_op(op, FP_SPEC, regs[a], regs[b], out=regs[d])
        h_ext = L.mont_mul(FP_SPEC, regs[0], self.t_inv)
        ints = limbs_to_ints(extended_to_coeff_limbs(self.domain, L.from_mont(FP_SPEC, h_ext)))
        return [ints[i * ext : (i + 1) * ext] for i in range(nb)]


class QuotientEvaluator(BatchQuotientEvaluator):
    """One proof's quotient: a batch of one. __call__(polys, challenges) ->
    h coefficients."""

    def __call__(self, coeff_polys_by_key: dict, challenges: tuple) -> list[int]:
        return super().__call__([coeff_polys_by_key], [challenges])[0]
