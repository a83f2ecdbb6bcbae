"""feed_idle_share.fed: the share of the traced window the card sits idle
while the host is inside one of the device feed's spans (``feed.*``:
fetch, pin, upload), put on the trace's clock (``program_trace``)."""

from benchmarks import program_trace


def read(ctx):
    p, t = program_trace.read(ctx), ctx.trace
    if p is None or t.window_s <= 0 or not p.spans_named("feed.fetch"):
        return None
    return p.idle_under(t, "feed.") / t.window_s
