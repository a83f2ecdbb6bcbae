"""attn_roofline.infer: the least time K1 could take for the stage calls
in the traced window (every layer at every generated token, over the
call's rows and bucket, no lse written) over the time the trace shows K1
running, in percent."""

from benchmarks.flops import kernel_bound


def read(ctx):
    w, t = ctx.window, ctx.trace
    spent = t.port_kernel_seconds()["flash_fwd"]
    if not w.get("calls") or spent <= 0:
        return None
    s = ctx.cell.family.sizes(ctx.cell.config)
    hd = s["d"] // s["heads"]
    bound = sum(s["layers"] * w["max_new_tokens"] * kernel_bound(
        "flash_fwd_infer", (len(rows), s["heads"], bucket, hd), True,
        ctx.run.peaks) for _, _, rows, bucket in w["calls"])
    return 100.0 * bound / spent
