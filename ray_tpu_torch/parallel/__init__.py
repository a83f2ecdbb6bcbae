"""ray_tpu_torch.parallel: the port's counterpart of ``ray_tpu.parallel``.

* mesh.py       — MeshConfig/make_mesh/make_multislice_mesh: a DeviceMesh
                  with the dp/fsdp/pp/sp/ep/tp axes (and dp_dcn across
                  slices) over the torch.distributed world, one device a
                  rank.
* ops.py        — collectives by axis name and ``shard_map``, which binds
                  the names to the mesh's process groups (gloo on the
                  CPU and for ranks that share a card, NCCL between
                  cards).
* partition.py  — logical-axis partition rules (Megatron-style TP,
                  ZeRO/FSDP, multi-slice DCN tables) and PartitionSpec;
                  ``models/_training.place_params`` reads them.
* pipeline.py   — GPipe and 1F1B pipelines over ``pp``.
* sequence.py   — ring attention and Ulysses over ``sp``.
* moe.py        — top-2 routing with capacity, dense or expert-parallel
                  over ``ep``.
* launch.py     — rank processes on one host (``RankPool``).
* dryrun.py     — ``dryrun_multichip``: every strategy once.
"""

from .mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshConfig,
    best_mesh_shape,
    local_slice_info,
    make_1d_mesh,
    make_mesh,
    make_multislice_mesh,
    mesh_axis_size,
    slice_count,
)
from .partition import (  # noqa: F401
    PartitionRules,
    PartitionSpec,
    dcn_rules,
    fsdp_rules,
    logical_to_mesh_axes,
    named_sharding,
    tp_rules,
    tree_shardings,
)
