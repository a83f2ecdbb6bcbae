"""padding_share.infer: the share of the positions the stage computes in
the traced window that hold left padding, 1 - ``llm.positions_real`` /
``llm.positions_computed`` (the program's counts at each decode step:
rows x bucket computed, and each row's prompt and answer so far)."""

from benchmarks import program_trace


def read(ctx):
    p = program_trace.read(ctx)
    if p is None:
        return None
    computed = p.count("llm.positions_computed")
    if not computed:
        return None
    return 1.0 - p.count("llm.positions_real") / computed
