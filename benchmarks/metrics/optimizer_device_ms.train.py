"""optimizer_device_ms.train: device milliseconds a training step of the
program's ``train.optimizer`` ranges (AdamW's kernels over every leaf,
between two CUDA events on the step's stream), over the traced window's
steps."""

from benchmarks import program_trace


def read(ctx):
    p, steps = program_trace.read(ctx), ctx.window.get("steps")
    if p is None or not steps:
        return None
    ms = p.device_ms(("train.optimizer",))
    return None if ms is None else ms / steps
