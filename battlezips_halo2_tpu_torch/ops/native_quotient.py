"""The quotient on the native host engine: the host twin of
ops/gate_eval.py's evaluators.

It runs the SAME bytecode that ``gate_eval.emit_vm`` emits for kernel K1's
VM, on the native library's row-blocked VM (``pasta_vm_exec``), with the
coset extension and the final extended iNTT on the native batch NTT. The
instruction stream and the field ops are the same, so the quotient is the
same to the bit; the golden proof vectors pin it.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..fields.host import FP
from ..plonk.arguments import ProofSchedule
from .gate_eval import _quotient_constants_native, emit_vm, quotient_poly_keys

P = FP.modulus


def _as_bytes(vals) -> np.ndarray:
    pre = getattr(vals, "bytes_arr", None)  # poly/polyints.py::PolyInts
    return pre if pre is not None else native.ints_to_bytes_arr([v % P for v in vals])


class NativeQuotientEvaluator:
    """Built once per verifying key; ``__call__(polys_by_key, challenges)``
    -> the quotient's coefficients, as ``gate_eval.QuotientEvaluator``."""

    def __init__(self, vk, schedule: ProofSchedule):
        domain = vk.domain
        self.domain = domain
        self.keys = quotient_poly_keys(vk.cs, schedule.num_perm_chunks)
        self.key_index = {k: i for i, k in enumerate(self.keys)}
        self.which = native.which_for(P)
        self.rot_scale = domain.extended_n // domain.n
        self.prog, self.pin_keys, self.n_regs = emit_vm(vk, schedule)
        consts = _quotient_constants_native(vk)  # whatever BZ_PROOF_ENGINE says
        self.named = {name: _as_bytes(consts[name]) for name in ("l0", "llast", "lactive", "x")}
        self.named["one"] = np.broadcast_to(
            np.frombuffer((1).to_bytes(32, "little"), dtype=np.uint8), (domain.extended_n, 32)
        )
        self.t_inv = _as_bytes(consts["t_inv"])

    def __call__(self, coeff_polys_by_key: dict, challenges: tuple) -> list[int]:
        domain = self.domain
        ext = domain.extended_n
        which = self.which

        # coset extension: scale by g^j, then the size-ext NTT
        batch = np.zeros((len(self.keys), ext, 32), dtype=np.uint8)
        for i, key in enumerate(self.keys):
            poly = coeff_polys_by_key[key]
            batch[i, : len(poly)] = _as_bytes(poly)
        native.scale_batch(which, batch, domain.g_coset, 1)
        native.ntt_batch(which, batch, domain.extended_omega)

        # bind the pinned registers
        chal = dict(zip(("theta", "beta", "gamma", "y"), challenges))
        regs = np.zeros((self.n_regs, ext, 32), dtype=np.uint8)
        for pi, key in enumerate(self.pin_keys):
            if key[0] == "inp":
                _, kind, index, rot = key
                arr = batch[self.key_index[(kind, index)]]
                regs[1 + pi] = np.roll(arr, -rot * self.rot_scale, axis=0) if rot else arr
            elif key[0] == "const":
                regs[1 + pi] = np.frombuffer((key[1] % P).to_bytes(32, "little"), dtype=np.uint8)
            elif key[0] == "chal":
                regs[1 + pi] = np.frombuffer((chal[key[1]] % P).to_bytes(32, "little"), dtype=np.uint8)
            else:  # named
                regs[1 + pi] = self.named[key[1]]

        agg = native.vm_exec(which, self.prog, regs)
        h_ext = native.mul_vec(which, agg, self.t_inv)

        # extended iNTT and coset unscale
        hb = np.ascontiguousarray(h_ext.reshape(1, ext, 32))
        native.ntt_batch(which, hb, pow(domain.extended_omega, -1, P))
        native.scale_batch(which, hb, domain.g_coset_inv, pow(ext, -1, P))
        return native.bytes_arr_to_ints(hb.reshape(ext, 32))
