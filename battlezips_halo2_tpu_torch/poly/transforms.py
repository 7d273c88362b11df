"""Batched basis transforms on device: the prover's NTT workhorse.

The ``*_limbs`` functions take and return ``(B, size, 8)`` canonical Fp limb
tensors and run on the tensors' device: each is an NTT (kernel K4, or K5
under BZ_ROW_NTT) between at most two products of kernel K1 by a scale
vector. The NTT multiplies only by Montgomery-form twiddles, so it maps
canonical rows to canonical rows and Montgomery rows to Montgomery rows;
a representation change needs no pass of its own, only a power of R folded
into a scale vector (:func:`_ntt_scaled`). The vectors are built once per
size, generator and device a process (ops/ntt.py::scale_vector). The
quotient's extensions also come Montgomery-out and go back Montgomery-in
(``mont_out`` / ``mont_in``), since its program works in Montgomery form.
K1 launches: lagrange_to_coeff 1 (the 1/n scale), coeff_to_lagrange 0,
coeff_to_extended 1 (the coset scale, on the unpadded coefficients),
extended_to_coeff 1 (coset and 1/n in one). The ``batch_*``
functions wrap them for lists of Python-int columns, converting only at the
edges, as the reference's poly/transforms.py does; where BZ_PROOF_ENGINE
sends the domain to the native host engine (ops/engine.py) they run there
instead and return PolyInts (poly/polyints.py) that carry their bytes.

Under an active mesh (parallel/context.py) the four ``batch_*`` transforms
and :func:`lagrange_to_coeff_limbs` (the iNTT of
``pcs/ipa.py::commit_lagrange_many``) run the 4-step NTT of
parallel/ntt.py over the mesh, ahead of the engine routing, where its
shape gate takes the size (:func:`_maybe_sharded`). The quotient's own
extended transforms (ops/gate_eval.py) stay unsharded, as in the
reference.
"""

from __future__ import annotations

import torch

from ..fields import limb as L
from ..fields.host import FP
from ..fields.limb import FP_SPEC, ints_to_limbs, limbs_to_ints
from ..ops import ntt as D
from .domain import EvaluationDomain

P = FP.modulus
R = FP_SPEC.r_mod_p


def _scale(g: int, k: int, n: int, device) -> torch.Tensor:
    """The cached operand of one K1 product: (n, 8) limbs of k g^i, or the
    (1, 8) limbs of k where g = 1. A product by it scales row i by
    k g^i R^-1, so k = s R scales by s, s R^2 also converts canonical to
    Montgomery form and s alone converts Montgomery to canonical form."""
    return D.scale_vector(P, g, n if g != 1 else 1, k, device)


def _ntt_scaled(x: torch.Tensor, n: int, omega: int, pre=None, post=None) -> torch.Tensor:
    """NTT (with omega) of the (B, rows, 8) batch x, rows <= n, zero-padded
    to n rows, between K1 products by the (g, k) scales ``pre`` (on the
    unpadded rows) and ``post`` (:func:`_scale`), each skipped when None;
    -> a new (B, n, 8) tensor."""
    dev, rows = x.device, x.shape[1]
    if pre is not None:
        x = L.mont_mul(FP_SPEC, x, _scale(*pre, n, dev)[:rows])
    if rows < n:
        padded = torch.zeros(x.shape[0], n, L.NLIMBS, dtype=torch.int32, device=dev)
        padded[:, :rows] = x
        x = padded
    y = D.ntt(D.plan_for(P, n, omega, str(dev)), x)  # a new tensor: x is never written
    if post is not None:
        L.mont_mul(FP_SPEC, y, _scale(*post, n, dev), out=y)
    return y


def _maybe_sharded(batch, n: int, omega: int, pre_g: int = 1, post_g: int = 1, post_k: int = 1):
    """Under an active mesh whose shape gate takes size n, the transform
    (scale by pre_g^i, NTT with omega, scale by post_k post_g^i) of the
    (B, n, 8) canonical batch that ``batch()`` builds, over the mesh
    (parallel/ntt.py::sharded_transform_batch); else None (a size the gate
    refuses is counted and named there)."""
    from ..parallel.context import get_mesh, mesh_is_active
    from ..parallel.ntt import sharded_transform_batch, sharded_transform_supported

    if not mesh_is_active() or not sharded_transform_supported(get_mesh(), n):
        return None
    return sharded_transform_batch(get_mesh(), n, omega, batch(), pre_g, post_g, post_k)


def lagrange_to_coeff_limbs(domain: EvaluationDomain, vals: torch.Tensor) -> torch.Tensor:
    out = _maybe_sharded(lambda: vals, domain.n, pow(domain.omega, -1, P), post_k=pow(domain.n, -1, P))
    return out if out is not None else _lagrange_to_coeff_unsharded(domain, vals)


def _lagrange_to_coeff_unsharded(domain: EvaluationDomain, vals: torch.Tensor) -> torch.Tensor:
    n = domain.n
    return _ntt_scaled(vals, n, pow(domain.omega, -1, P), post=(1, pow(n, -1, P) * R))


def coeff_to_lagrange_limbs(domain: EvaluationDomain, coeffs: torch.Tensor) -> torch.Tensor:
    return _ntt_scaled(coeffs, domain.n, domain.omega)


def coeff_to_extended_limbs(domain: EvaluationDomain, coeffs: torch.Tensor, mont_out: bool = False) -> torch.Tensor:
    """(B, <= ext, 8) canonical coefficients -> evaluations on the extended
    coset {g_coset * ext_omega^i}, canonical or, with ``mont_out``, in
    Montgomery form."""
    pre = (domain.g_coset, R * R if mont_out else R)
    return _ntt_scaled(coeffs, domain.extended_n, domain.extended_omega, pre=pre)


def extended_to_coeff_limbs(domain: EvaluationDomain, evals: torch.Tensor, mont_in: bool = False) -> torch.Tensor:
    """(B, ext, 8) evaluations on the extended coset, canonical or, with
    ``mont_in``, in Montgomery form -> canonical coefficients."""
    ext = domain.extended_n
    post = (domain.g_coset_inv, pow(ext, -1, P) * (1 if mont_in else R))
    return _ntt_scaled(evals, ext, pow(domain.extended_omega, -1, P), post=post)


def _to_limbs(columns: list, size: int, device) -> torch.Tensor:
    flat = []
    for col in columns:
        flat.extend(v % P for v in col)
        flat.extend([0] * (size - len(col)))
    return ints_to_limbs(flat, device).reshape(len(columns), size, L.NLIMBS)


def _to_lists(t: torch.Tensor) -> list[list[int]]:
    flat = limbs_to_ints(t)
    size = t.shape[1]
    return [flat[i : i + size] for i in range(0, len(flat), size)]


def _maybe_native(columns: list, n: int, omega: int, pre_g: int = 1, post_g: int = 1, post_k: int = 1):
    """The native host engine's transform of size n (scale by pre_g^i,
    NTT with omega, scale by post_k post_g^i) when ops/engine.py routes
    size n there; else None."""
    from ..ops.engine import use_host_engine

    if not use_host_engine(n):
        return None
    import numpy as np

    from .. import native
    from .polyints import PolyInts

    which = native.which_for(P)
    data = np.zeros((len(columns), n, 32), np.uint8)
    for i, col in enumerate(columns):
        data[i, : len(col)] = native.ints_to_bytes_arr([v % P for v in col])
    if pre_g != 1:
        native.scale_batch(which, data, pre_g, 1)
    native.ntt_batch(which, data, omega)
    if post_g != 1 or post_k != 1:
        native.scale_batch(which, data, post_g, post_k)
    return [PolyInts.wrap(native.bytes_arr_to_ints(row), row) for row in data]


def batch_lagrange_to_coeff(domain: EvaluationDomain, columns: list, device) -> list[list[int]]:
    if not columns:
        return []
    n, omega_inv, n_inv = domain.n, pow(domain.omega, -1, P), pow(domain.n, -1, P)
    out = _maybe_sharded(lambda: _to_limbs(columns, n, device), n, omega_inv, post_k=n_inv)
    if out is not None:
        return _to_lists(out)
    out = _maybe_native(columns, n, omega_inv, post_k=n_inv)
    if out is not None:
        return out
    return _to_lists(_lagrange_to_coeff_unsharded(domain, _to_limbs(columns, n, device)))


def batch_coeff_to_lagrange(domain: EvaluationDomain, polys: list, device) -> list[list[int]]:
    if not polys:
        return []
    out = _maybe_sharded(lambda: _to_limbs(polys, domain.n, device), domain.n, domain.omega)
    if out is not None:
        return _to_lists(out)
    out = _maybe_native(polys, domain.n, domain.omega)
    if out is not None:
        return out
    return _to_lists(coeff_to_lagrange_limbs(domain, _to_limbs(polys, domain.n, device)))


def batch_coeff_to_extended(domain: EvaluationDomain, polys: list, device) -> list[list[int]]:
    if not polys:
        return []
    ext = domain.extended_n
    out = _maybe_sharded(lambda: _to_limbs(polys, ext, device), ext, domain.extended_omega, pre_g=domain.g_coset)
    if out is not None:
        return _to_lists(out)
    out = _maybe_native(polys, ext, domain.extended_omega, pre_g=domain.g_coset)
    if out is not None:
        return out
    rows = max(len(p) for p in polys)  # padded to ext on the device, after the coset scale
    return _to_lists(coeff_to_extended_limbs(domain, _to_limbs(polys, rows, device)))


def batch_extended_to_coeff(domain: EvaluationDomain, evals: list, device) -> list[list[int]]:
    if not evals:
        return []
    ext = domain.extended_n
    omega_inv, post = pow(domain.extended_omega, -1, P), dict(post_g=domain.g_coset_inv, post_k=pow(ext, -1, P))
    out = _maybe_sharded(lambda: _to_limbs(evals, ext, device), ext, omega_inv, **post)
    if out is not None:
        return _to_lists(out)
    out = _maybe_native(evals, ext, omega_inv, **post)
    if out is not None:
        return out
    return _to_lists(extended_to_coeff_limbs(domain, _to_limbs(evals, ext, device)))
