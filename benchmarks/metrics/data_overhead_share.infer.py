"""data_overhead_share.infer: 1 - (the time inside the stage's calls, the
harness's ``bench.stage_call`` span) / the window: the share the Data
layer and the harness take around the model."""


def read(ctx):
    w = ctx.window
    if not w.get("seconds"):
        return None
    inside = ctx.run.spans.total("bench.stage_call", w["start"], w["end"])
    return 1.0 - inside / w["seconds"]
