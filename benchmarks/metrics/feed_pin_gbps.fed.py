"""feed_pin_gbps.fed: the rate of the device feed's copy into pinned
memory, GB (1e9 bytes) a second: the bytes the program counts after each
``feed.pin`` span (``feed.bytes``) over those spans' host seconds, for
the spans wholly inside the traced window."""

import bisect

from benchmarks import program_trace


def read(ctx):
    p = program_trace.read(ctx)
    if p is None:
        return None
    pins = p.spans_named("feed.pin")
    counts = sorted((t, n) for name, t, n in p.counts
                    if name == "feed.bytes")
    stamps = [t for t, _ in counts]
    copied = seconds = 0.0
    for a, b in pins:
        # Each span's bytes are counted as it ends, before the next one.
        i = bisect.bisect_left(stamps, b)
        if i < len(counts):
            copied += counts[i][1]
            seconds += b - a
    return copied / 1e9 / seconds if seconds > 0 else None
