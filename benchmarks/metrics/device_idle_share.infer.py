"""device_idle_share.infer: 1 - (the union of kernel, copy and memset
intervals) / the traced window, in a batch-generation cell."""


def read(ctx):
    return ctx.trace.idle_share()
