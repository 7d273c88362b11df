"""Batched basis transforms on device: the prover's NTT workhorse.

The ``*_limbs`` functions take and return ``(B, size, 8)`` canonical Fp limb
tensors and run on the tensors' device (Montgomery conversion and coset
scaling on kernel K1, the transforms on kernel K4). The ``batch_*``
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


def _n_inv(n: int, device) -> torch.Tensor:
    return ints_to_limbs([pow(n, -1, P) * FP_SPEC.r_mod_p % P], device)


def _scale(g: int, n: int, device) -> torch.Tensor:
    return D.make_scale_vector(FP, g, n, FP_SPEC, device)


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
    dev = vals.device
    plan_inv = D.plan_for(P, domain.n, pow(domain.omega, -1, P), str(dev))
    m = D.intt(plan_inv, L.to_mont(FP_SPEC, vals), _n_inv(domain.n, dev))
    return L.from_mont(FP_SPEC, m)


def coeff_to_lagrange_limbs(domain: EvaluationDomain, coeffs: torch.Tensor) -> torch.Tensor:
    plan = D.plan_for(P, domain.n, domain.omega, str(coeffs.device))
    return L.from_mont(FP_SPEC, D.ntt(plan, L.to_mont(FP_SPEC, coeffs)))


def coeff_to_extended_limbs(domain: EvaluationDomain, coeffs: torch.Tensor) -> torch.Tensor:
    """(B, <= ext, 8) coefficients -> evaluations on the extended coset
    {g_coset * ext_omega^i}."""
    dev, ext = coeffs.device, domain.extended_n
    padded = torch.zeros(coeffs.shape[0], ext, L.NLIMBS, dtype=torch.int32, device=dev)
    padded[:, : coeffs.shape[1]] = coeffs
    pm = L.to_mont(FP_SPEC, padded)
    L.mont_mul(FP_SPEC, pm, _scale(domain.g_coset, ext, dev), out=pm)
    plan = D.plan_for(P, ext, domain.extended_omega, str(dev))
    return L.from_mont(FP_SPEC, D.ntt(plan, pm))


def extended_to_coeff_limbs(domain: EvaluationDomain, evals: torch.Tensor) -> torch.Tensor:
    dev, ext = evals.device, domain.extended_n
    plan_inv = D.plan_for(P, ext, pow(domain.extended_omega, -1, P), str(dev))
    pm = D.intt(plan_inv, L.to_mont(FP_SPEC, evals), _n_inv(ext, dev))
    L.mont_mul(FP_SPEC, pm, _scale(domain.g_coset_inv, ext, dev), out=pm)
    return L.from_mont(FP_SPEC, pm)


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
    return _to_lists(coeff_to_extended_limbs(domain, _to_limbs(polys, ext, device)))


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
