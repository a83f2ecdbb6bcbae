"""loss_device_ms.train: device milliseconds a training step of the
program's ``model.loss`` ranges (the head's products and the cross
entropy, from the head's input to the scalar, forward and backward),
timed by the program's CUDA events (``program_trace``)."""

from benchmarks import program_trace


def read(ctx):
    p, steps = program_trace.read(ctx), ctx.window.get("steps")
    if p is None or not steps:
        return None
    ms = p.device_ms(("model.loss",))
    return None if ms is None else ms / steps
