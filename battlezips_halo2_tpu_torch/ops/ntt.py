"""Radix-2 NTT / iNTT over limb tensors.

``ntt`` takes ``(..., n, 8)`` Montgomery-form rows in natural order and
returns them transformed in natural order: one bit-reverse gather, then
log2(n) in-place decimation-in-time stages. Each stage is one launch of
kernel K4 (``csrc/ntt_stage.cu``): a thread per butterfly
``(u, v) <- (u + v w_j, u - v w_j)`` over the whole batch. Bit-exact against
poly/domain.py::ntt_host.

Under ``BZ_ROW_NTT`` a stage takes the reference's row-layout route
instead: gather u and v by the stage's index tables, kernel K5
(``csrc/butterfly_rows.cu``) writes u + v tw and u - v tw to two new
tensors, and their concatenation is gathered back into order. Under
``BZ_NTT_MM=on`` the whole NTT is the 4-step matrix-product one of
``ops/ntt_mm.py`` (kernel M1), which takes precedence over both.
"""

from __future__ import annotations

import functools

import torch

from ..config import config
from ..fields import limb as L
from ..fields.host import Field
from ..fields.limb import FieldSpec, geometric_limbs, ints_to_limbs
from ..poly.domain import bit_reverse
from .ntt_mm import mm_plan_for, ntt_mm


class NttPlan:
    """Bit-reverse permutation and per-stage Montgomery twiddles for one
    (field, n, omega) on one device."""

    def __init__(self, spec: FieldSpec, n: int, omega: int, device):
        self.spec = spec
        self.n = n
        self.omega = omega
        self.logn = n.bit_length() - 1
        m, r = spec.modulus, spec.r_mod_p
        self.rev_idx = torch.tensor(
            [bit_reverse(i, self.logn) for i in range(n)], dtype=torch.int64, device=device
        )
        self.stage_twiddles = []  # stage s: (2^s, 8), w_j = omega^(j n / 2^(s+1))
        for s in range(self.logn):
            half = 1 << s
            w_len = pow(omega, n // (2 * half), m)
            tw, w = [], r
            for _ in range(half):
                tw.append(w)
                w = w * w_len % m
            self.stage_twiddles.append(ints_to_limbs(tw, device))
        self._row_tables = None

    def row_tables(self) -> list:
        """Per stage ``(idx_u, idx_v, idx_out, tw_full)``, the reference's
        row-layout tables (its NttPlan.stage_idx_u / stage_idx_v /
        stage_idx_out / stage_tw_full), built on first use: pair (g, j) of
        stage s has u at g 2^(s+1) + j and v 2^s further on, tw_full holds
        its twiddle w_j, and idx_out puts the concatenated outputs back."""
        if self._row_tables is None:
            dev, n, tables = self.rev_idx.device, self.n, []
            for s, tw in enumerate(self.stage_twiddles):
                half, groups = 1 << s, n >> (s + 1)
                g = torch.arange(groups, device=dev).repeat_interleave(half)
                j = torch.arange(half, device=dev).repeat(groups)
                idx_u = g * (2 * half) + j
                idx_v = idx_u + half
                idx_out = torch.empty(n, dtype=torch.int64, device=dev)
                idx_out[idx_u] = torch.arange(n // 2, device=dev)
                idx_out[idx_v] = torch.arange(n // 2, n, device=dev)
                tables.append((idx_u, idx_v, idx_out, tw.repeat(groups, 1)))
            self._row_tables = tables
        return self._row_tables


@functools.lru_cache(maxsize=None)
def plan_for(modulus: int, n: int, omega: int, device: str) -> NttPlan:
    return NttPlan(FieldSpec.make(modulus), n, omega, device)


def butterfly_stage_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, stage: int) -> torch.Tensor:
    """The plain PyTorch version of K4: stage ``stage`` of x (B, n, 8) -> new tensor."""
    b, n = x.shape[:2]
    half = 1 << stage
    g = x.reshape(b, n // (2 * half), 2, half, L.NLIMBS)
    u, v = g[:, :, 0], g[:, :, 1]
    vt = L.mont_mul_plain(spec, v, tw)
    return torch.stack((L.add_plain(spec, u, vt), L.sub_plain(spec, u, vt)), dim=2).reshape(x.shape)


def butterfly_stage(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, stage: int) -> None:
    """K4: one DIT stage in place over x (B, n, 8) with twiddles tw (2^stage, 8).
    A CUDA tensor launches the kernel; a CPU tensor runs the plain version."""
    b, n = x.shape[:2]
    if x.dim() != 3 or x.shape[2] != L.NLIMBS or n & (n - 1) or tw.shape != (1 << stage, L.NLIMBS):
        raise ValueError(f"bad NTT stage operands: x {tuple(x.shape)}, tw {tuple(tw.shape)}, stage {stage}")
    if not x.is_cuda:
        x.copy_(butterfly_stage_plain(spec, x, tw, stage))
        return
    from . import cuda

    cuda.require(x, torch.int32, "K4 NTT stage")
    cuda.require(tw, torch.int32, "K4 NTT twiddles")
    if b:
        logn = n.bit_length() - 1
        cuda.launch("K4", "bz_ntt_stage", x, spec.kernel_consts, cuda.ptr(x), cuda.ptr(tw), b, logn, stage)


def butterfly_rows_plain(spec: FieldSpec, u: torch.Tensor, v: torch.Tensor, tw: torch.Tensor):
    """The plain PyTorch version of K5: (u + v tw, u - v tw)."""
    vt = L.mont_mul_plain(spec, v, tw)
    return L.add_plain(spec, u, vt), L.sub_plain(spec, u, vt)


def butterfly_rows(spec: FieldSpec, u: torch.Tensor, v: torch.Tensor, tw: torch.Tensor):
    """K5: u, v (B, n/2, 8) and tw (n/2, 8), one twiddle per pair ->
    (u + v tw, u - v tw) as two new tensors. A CUDA tensor launches the
    kernel; a CPU tensor runs the plain version."""
    if u.dim() != 3 or u.shape != v.shape or u.shape[2] != L.NLIMBS or tw.shape != u.shape[1:]:
        raise ValueError(f"bad butterfly rows: u {tuple(u.shape)}, v {tuple(v.shape)}, tw {tuple(tw.shape)}")
    if not u.is_cuda:
        return butterfly_rows_plain(spec, u, v, tw)
    from . import cuda

    for t, what in ((u, "K5 u"), (v, "K5 v"), (tw, "K5 twiddles")):
        cuda.require(t, torch.int32, what)
    out0, out1 = torch.empty_like(u), torch.empty_like(u)
    batch, n2 = u.shape[:2]
    if batch * n2:
        cuda.launch(
            "K5", "bz_butterfly_rows", u,
            spec.kernel_consts, cuda.ptr(u), cuda.ptr(v), cuda.ptr(tw), cuda.ptr(out0), cuda.ptr(out1), batch, n2,
        )
    return out0, out1


def ntt(plan: NttPlan, a: torch.Tensor) -> torch.Tensor:
    """NTT of Montgomery-form rows (..., n, 8), natural order in and out.
    Under ``BZ_NTT_MM=on`` it is the 4-step matrix-product NTT
    (ops/ntt_mm.py, kernel M1) at every n; ``intt``, the basis transforms
    and the sharded NTT's local transforms all come through here."""
    cfg = config()
    if cfg.ntt_mm:
        # The reference checks BZ_NTT_MM first too, and its "auto" takes the
        # matrix-product route only on a TPU backend, for 2^16 <= n <= 2^21
        # (battlezips_halo2_tpu/ops/ntt.py:216-224, _pallas_ok at :255-258).
        # This port has no TPU, so "auto" is "off" here, as it is in the
        # reference on any other backend.
        return ntt_mm(mm_plan_for(plan.spec.modulus, plan.n, plan.omega, str(plan.rev_idx.device)), a)
    x = a.reshape(-1, plan.n, L.NLIMBS).index_select(1, plan.rev_idx)
    if cfg.row_ntt:
        for idx_u, idx_v, idx_out, tw_full in plan.row_tables():
            out0, out1 = butterfly_rows(plan.spec, x.index_select(1, idx_u), x.index_select(1, idx_v), tw_full)
            x = torch.cat((out0, out1), dim=1).index_select(1, idx_out)
        return x.reshape(a.shape)
    for s in range(plan.logn):
        butterfly_stage(plan.spec, x, plan.stage_twiddles[s], s)
    return x.reshape(a.shape)


def intt(plan_inv: NttPlan, a: torch.Tensor, n_inv_mont: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: ntt with the inverse-omega plan, then scale by
    ``n_inv_mont`` ((1, 8) limbs of n^-1 in Montgomery form)."""
    out = ntt(plan_inv, a)
    return L.mont_mul(plan_inv.spec, out, n_inv_mont, out=out)


@functools.lru_cache(maxsize=None)
def _cached_scale_vector(modulus: int, g: int, n: int, factor: int, device: str) -> torch.Tensor:
    return geometric_limbs(modulus, factor, g, n, device)


def scale_vector(modulus: int, g: int, n: int, factor: int, device) -> torch.Tensor:
    """The (n, 8) limbs of factor * g^i mod modulus, i < n: one K1 product
    by it scales row i by g^i factor R^-1. Built once per (modulus, g, n,
    factor, device) a process and kept: callers must not write into it."""
    return _cached_scale_vector(modulus, g % modulus, n, factor % modulus, str(torch.device(device)))


def make_scale_vector(field: Field, g: int, n: int, spec: FieldSpec, device) -> torch.Tensor:
    """Powers g^i, i < n, as (n, 8) Montgomery limbs (coset scaling): the
    vector of :func:`scale_vector` with factor R, from its cache
    (``_cached_scale_vector``, one tensor per size, generator and device a
    process); callers must not write into it."""
    return scale_vector(field.modulus, g, n, spec.r_mod_p, device)
