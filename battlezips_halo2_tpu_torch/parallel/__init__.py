"""Parallelism over several devices and processes: meshes, collectives, the
sharded MSM and the 4-step NTT (parallel/collectives.py says how data
moves; parallel/context.py how the prover is routed onto a mesh;
parallel/distributed.py how processes join one).

The port's counterpart of the reference's ``battlezips_halo2_tpu/parallel``
(``jax.sharding.Mesh`` and ``jax.lax`` collectives): a list of torch
devices, device-to-device copies in one process, ``torch.distributed``
(NCCL, gloo) across processes.
"""

from .collectives import default_mesh, mesh_from_devices
from .msm import sharded_msm
from .ntt import distributed_ntt

__all__ = ["default_mesh", "mesh_from_devices", "sharded_msm", "distributed_ntt"]
