"""host_calls_per_frame — frame loop: the host's CUDA runtime calls that
launch or copy (graph launches, kernel launches, memcpys, memsets) inside
the benchmark's ``portbench.frame`` spans and outside its
``portbench.sample`` spans (the check's copies), per frame (torch.profiler
CPU events; ``profile_port.py`` counted launch calls so)."""

CALLS = ("Launch", "Memcpy", "Memset")


def read(ctx):
    frames = ctx.spans_named("frame")
    if not frames:
        return None
    copies = {r[3] for r in ctx.runtime_in(ctx.spans_named("sample"))}
    calls = [r for r in ctx.runtime_in(frames)
             if any(c in r[0] for c in CALLS) and r[3] not in copies]
    return len(calls) / len(frames)
