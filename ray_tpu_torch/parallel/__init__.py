"""ray_tpu_torch.parallel: the port's counterpart of ``ray_tpu.parallel``.

So far ``moe.py`` alone, on one device: top-2 routing with capacity and
the dense expert dispatch. The mesh strategies (data, tensor, sequence,
pipeline and expert parallelism) come with the parallel-strategies slice
(``ROADMAP.md``, Queue 1)."""
