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


def _world(device_type: Optional[str] = None) -> Tuple[int, str]:
    """(world size, device type) of the initialized default group: CUDA
    under NCCL, the CPU under gloo unless ``device_type`` says ``"cuda"``
    (ranks that share one card talk gloo: NCCL takes one rank a GPU)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans a torch.distributed world: initialize the "
            "process group first (TorchTrainer's backend does, in each "
            "worker)")
    backend = dist.get_backend()
    if device_type is None:
        device_type = "cuda" if backend == "nccl" else "cpu"
    if backend == "nccl" and device_type != "cuda":
        raise ValueError(f"a {device_type} mesh over NCCL")
    return dist.get_world_size(), device_type


def make_mesh(config: Optional[MeshConfig] = None,
              axis_names: Optional[Sequence[str]] = None,
              device_type: Optional[str] = None):
    """A DeviceMesh over the whole world with the framework's axis names
    (every name of ``AXIS_ORDER``, size 1 where the config leaves it).
    ``device_type`` defaults to the backend's (see ``_world``)."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    world, device_type = _world(device_type)
    shape_map = config.resolve(world)
    names = tuple(axis_names or AXIS_ORDER)
    shape = tuple(shape_map.get(a, 1) for a in names)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def slice_count(slice_ids: Optional[Sequence[int]] = None) -> int:
    """Number of slices among the ranks: the distinct ids in
    ``slice_ids`` (one per rank). torch.distributed ranks carry no slice
    id, so with none given the world is one slice, as JAX counts CPU
    and single-slice backends."""
    return max(1, len(set(slice_ids or ())))


def make_multislice_mesh(config: Optional[MeshConfig] = None,
                         dcn_axis: str = "dp_dcn",
                         num_slices: Optional[int] = None,
                         device_type: Optional[str] = None):
    """A mesh over several slices: a leading data-parallel ``dcn_axis``
    over the slices, then the usual axes within each slice.

    Only data parallelism crosses the slow links between slices (one
    gradient all-reduce a step); the other axes stay inside a slice. The
    ranks carry no slice id, so ``num_slices`` says how many there are
    and slices are contiguous groups of ranks, as JAX emulates them on
    its CPU backend."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    world, device_type = _world(device_type)
    n_slices = num_slices or slice_count()
    if n_slices <= 1:
        raise ValueError(
            "make_multislice_mesh needs >1 slice (pass num_slices); use "
            "make_mesh for a single slice")
    if world % n_slices != 0:
        raise ValueError(f"{world} ranks not divisible into {n_slices} "
                         f"slices")
    shape_map = config.resolve(world // n_slices)
    names = (dcn_axis,) + AXIS_ORDER
    shape = (n_slices,) + tuple(shape_map.get(a, 1) for a in AXIS_ORDER)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_1d_mesh(axis: str = "dp", device_type: Optional[str] = None):
    """A one-axis DeviceMesh over the whole world."""
    from torch.distributed.device_mesh import init_device_mesh

    world, device_type = _world(device_type)
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def mesh_axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 1
    return int(mesh.size(names.index(axis)))


def local_slice_info() -> Dict[str, object]:
    """This rank's view of the world (JAX's process index and count,
    local and global devices, platform): one device a rank."""
    import torch
    import torch.distributed as dist

    backend = dist.get_backend()
    local = torch.cuda.device_count() if backend == "nccl" else 1
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": local,
        "global_devices": dist.get_world_size(),
        "platform": "gpu" if backend == "nccl" else "cpu",
    }
