"""htod_overlap_share.fed: the share of the host-to-device copies' time
in the traced window during which a kernel ran; nothing without copies."""


def read(ctx):
    return ctx.trace.htod_overlap_share()
