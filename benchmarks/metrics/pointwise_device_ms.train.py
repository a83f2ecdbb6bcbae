"""pointwise_device_ms.train: device milliseconds a training step of the
program's ``model.norm``, ``model.rope`` and ``model.act`` ranges (the
norms, rotary embedding and GELU of ``ops/layers.py``, forward,
recompute and backward), timed by the program's CUDA events
(``program_trace``)."""

from benchmarks import program_trace

POINTWISE = ("model.norm", "model.rope", "model.act")


def read(ctx):
    p, steps = program_trace.read(ctx), ctx.window.get("steps")
    if p is None or not steps:
        return None
    ms = p.device_ms(POINTWISE)
    return None if ms is None else ms / steps
