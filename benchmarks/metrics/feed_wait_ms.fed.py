"""feed_wait_ms.fed: the host milliseconds a step spends inside
``next()`` on the device feed (the harness's ``bench.feed_next`` span),
over the traced window's steps."""


def read(ctx):
    w = ctx.window
    steps = w.get("steps")
    if not steps:
        return None
    spans = ctx.run.spans
    if not spans.count("bench.feed_next", w["start"], w["end"]):
        return None
    return 1e3 * spans.total("bench.feed_next", w["start"], w["end"]) / steps
