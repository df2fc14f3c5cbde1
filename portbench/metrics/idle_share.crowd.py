"""idle_share.crowd — device: the share of the traced replays' device span
(first device operation to last) in which the device waits for the host,
in %: 1 - (the union of the device's operations, each CUDA graph replay
counted whole from its first kernel to its last) / the span. The profiler's
records of each kernel widen the gaps inside a replay (a traced frame runs
longer than an untraced one by about that, PERF.md), so those gaps count as
busy, and the gaps the host leaves between launches remain."""

from portbench.reference import arith


def read(ctx):
    if ctx.window_s <= 0 or not ctx.replays:
        return None
    busy = arith.union_us(ctx.replay_intervals()) / 1e6
    return 100.0 * (1.0 - busy / ctx.window_s)
