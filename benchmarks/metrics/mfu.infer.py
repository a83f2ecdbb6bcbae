"""mfu.infer: the forward FLOPs a KV-cached greedy decode of the rows the
window served needs (each real prompt once, each new token once, the head
where a token is chosen, attention over each real context;
``flops.gpt_decode_flops``) over the window's seconds and the card's bf16
peak, in percent."""

from benchmarks.flops import gpt_decode_flops


def read(ctx):
    w, t = ctx.window, ctx.trace
    if not w.get("rows") or t.window_s <= 0:
        return None
    s = ctx.cell.family.sizes(ctx.cell.config)
    total = sum(gpt_decode_flops(s["d"], s["layers"], s["heads"], s["f"],
                                 s["vocab"], n, w["max_new_tokens"])
                for n in w["lengths"])
    return 100.0 * total / t.window_s / ctx.run.peaks["bf16"]
