"""data_self_share.infer: the share of the window the Data layer spends in
its own code: the time under the program's ``data.*`` spans (get, batch,
apply) outside the user's function (``data.udf``, and so outside every
span nested under it), over the window's seconds."""

from benchmarks import program_trace


def _data(name):
    return name.startswith("data.") and name != "data.udf"


def read(ctx):
    p, seconds = program_trace.read(ctx), ctx.window.get("seconds")
    if p is None or not seconds or not p.spans_named("data.apply"):
        return None
    return p.exclusive_s(_data, lambda n: n == "data.udf") / seconds
