"""Device meshes over a torch.distributed world.

Counterpart of ``ray_tpu/parallel/mesh.py``: parallelism is declared as a
mesh with named axes over the world's ranks, one device a rank (NCCL
puts one rank on one GPU). The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` built by
``init_device_mesh`` over the default process group, which the trainer's
backend (or the caller) has initialized.

Axis conventions used across the framework (the JAX package's):
  * ``dp``   — data parallel (batch sharding; gradient all-reduce)
  * ``fsdp`` — param/optimizer sharding (ZeRO-equivalent)
  * ``tp``   — tensor parallel (Megatron partition of matmuls)
  * ``pp``   — pipeline stages
  * ``sp``   — sequence/context parallel (ring attention axis)
  * ``ep``   — expert parallel (MoE all_to_all axis)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "ep", "tp")


@dataclass
class MeshConfig:
    """Declarative mesh shape. Unset axes default to 1. `dp=-1` means
    "absorb all remaining devices" (like the reference ScalingConfig's
    num_workers covering the worker group)."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        fixed = {"fsdp": self.fsdp, "tp": self.tp, "pp": self.pp,
                 "sp": self.sp, "ep": self.ep}
        known = int(np.prod(list(fixed.values())))
        dp = self.dp
        if dp == -1:
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {known}")
            dp = n_devices // known
        total = dp * known
        if total != n_devices:
            raise ValueError(
                f"Mesh shape {dict(dp=dp, **fixed)} needs {total} devices, "
                f"have {n_devices}")
        return {"dp": dp, **fixed}


def best_mesh_shape(n_devices: int, model_parallel: int = 1
                    ) -> Tuple[int, int]:
    """(dp, tp) split for n devices given a model-parallel degree."""
    if n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} % {model_parallel} != 0")
    return n_devices // model_parallel, model_parallel


def _world() -> Tuple[int, str]:
    """(world size, device type) of the initialized default group: CUDA
    under NCCL, the CPU under gloo."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans a torch.distributed world: initialize the "
            "process group first (TorchTrainer's backend does, in each "
            "worker)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return dist.get_world_size(), device_type


def make_mesh(config: Optional[MeshConfig] = None,
              axis_names: Optional[Sequence[str]] = None):
    """A DeviceMesh over the whole world with the framework's axis names
    (every name of ``AXIS_ORDER``, size 1 where the config leaves it)."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    world, device_type = _world()
    shape_map = config.resolve(world)
    names = tuple(axis_names or AXIS_ORDER)
    shape = tuple(shape_map.get(a, 1) for a in names)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_1d_mesh(axis: str = "dp"):
    """A one-axis DeviceMesh over the whole world."""
    from torch.distributed.device_mesh import init_device_mesh

    world, device_type = _world()
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def mesh_axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 1
    return int(mesh.size(names.index(axis)))
