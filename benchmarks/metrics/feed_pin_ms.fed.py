"""feed_pin_ms.fed: host milliseconds a step the device feed spends
copying each batch into pinned memory (the program's ``feed.pin``
span), over the traced window's steps."""

from benchmarks import program_trace


def read(ctx):
    p, steps = program_trace.read(ctx), ctx.window.get("steps")
    if p is None or not steps or not p.spans_named("feed.pin"):
        return None
    return 1e3 * p.host_s("feed.pin") / steps
