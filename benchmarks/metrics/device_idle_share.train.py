"""device_idle_share.train: 1 - (the union of kernel, copy and memset
intervals) / the traced window, in a training cell."""


def read(ctx):
    return ctx.trace.idle_share()
