"""ray_tpu_torch.parallel: the port's counterpart of ``ray_tpu.parallel``.

* mesh.py       — MeshConfig/make_mesh: a DeviceMesh with the dp/fsdp/
                  pp/sp/ep/tp axes over the torch.distributed world, one
                  device a rank.
* partition.py  — logical-axis partition rules (Megatron-style TP,
                  ZeRO/FSDP tables); ``models/_training.place_params``
                  reads them. The data-parallel rules run; the other
                  axes wait for the parallel-strategies slice
                  (``ROADMAP.md``, Queue 1 item 5).
* moe.py        — top-2 routing with capacity and the dense expert
                  dispatch, on one device.
"""

from .mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshConfig,
    best_mesh_shape,
    make_1d_mesh,
    make_mesh,
    mesh_axis_size,
)
from .partition import (  # noqa: F401
    PartitionRules,
    fsdp_rules,
    logical_to_mesh_axes,
    tp_rules,
)
