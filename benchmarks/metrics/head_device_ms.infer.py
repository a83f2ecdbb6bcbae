"""head_device_ms.infer: device milliseconds a stage call of the
program's ``model.head`` ranges (``gpt_forward``'s head product over
every position of the bucket and its f32 cast, at every generated
token), over the ``llm.call`` spans wholly inside the traced window."""

from benchmarks import program_trace


def read(ctx):
    p = program_trace.read(ctx)
    if p is None:
        return None
    calls = p.spans_named("llm.call")
    if not calls:
        return None
    ms = p.device_ms(("model.head",), within=calls)
    return None if ms is None else ms / len(calls)
