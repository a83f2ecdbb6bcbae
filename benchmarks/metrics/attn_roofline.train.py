"""attn_roofline.train: the least time K1-K3 could take for the training
steps in the traced window (each launch's bound from its shape,
``flops.kernel_bound``) over the time the trace shows them running, in
percent."""

from benchmarks.flops import kernel_bound


def read(ctx):
    w, t = ctx.window, ctx.trace
    spent = sum(t.port_kernel_seconds().values())
    if not w.get("steps") or spent <= 0:
        return None
    per_step = sum(kernel_bound(k, shape, causal, ctx.run.peaks)
                   for k, shape, causal in w["attention"])
    return 100.0 * per_step * w["steps"] / spent
