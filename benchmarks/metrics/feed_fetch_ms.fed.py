"""feed_fetch_ms.fed: host milliseconds a step the device feed spends
taking the next batch from upstream (the program's ``feed.fetch`` span:
Data's block get, slice and zip), over the traced window's steps."""

from benchmarks import program_trace


def read(ctx):
    p, steps = program_trace.read(ctx), ctx.window.get("steps")
    if p is None or not steps or not p.spans_named("feed.fetch"):
        return None
    return 1e3 * p.host_s("feed.fetch") / steps
