"""mfu.train: the model FLOPs of the training steps in the traced window
(forward and backward, no recompute; ``flops.py``) over the window's
seconds and the card's bf16 peak, in percent."""


def read(ctx):
    w, t = ctx.window, ctx.trace
    if not w.get("steps") or t.window_s <= 0:
        return None
    return 100.0 * w["step_flops"] * w["steps"] / t.window_s \
        / ctx.run.peaks["bf16"]
