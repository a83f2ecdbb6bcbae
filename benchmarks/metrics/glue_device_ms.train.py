"""glue_device_ms.train: device milliseconds a training step of the
kernels that are none of the GEMMs, K1-K3 or the optimizer's (norms,
rope, GELU, casts, the loss's pieces: ``ops/layers.py`` and the plain
torch around the products), from the trace."""

from benchmarks.trace import GEMM_GROUP, OPTIMIZER_GROUP, kernel_group


def _glue(name):
    g = kernel_group(name)
    return not (g == GEMM_GROUP or g == OPTIMIZER_GROUP
                or g.startswith("K"))


def read(ctx):
    steps = ctx.window.get("steps")
    if not steps:
        return None
    return 1e3 * ctx.trace.kernel_seconds(_glue) / steps
