"""kernels_roofline — kernels: the port kernels' summed bytes floors
(``reference/arith.py``: each call's rays or pixels, triangles and
records read or written once, at 3.35 TB/s, from the shapes the frame
program's capture recorded and the live counts of its last replay) over
their summed device time in the traced window, in %."""

from portbench.reference.arith import floor_ms
from portbench.trace import is_port_kernel


def read(ctx):
    if not ctx.port_bytes_per_replay or not ctx.frames:
        return None
    us = sum(e - s for name, s, e, _ in ctx.device if is_port_kernel(name))
    if us <= 0:
        return None
    return 100.0 * floor_ms(ctx.port_bytes_per_replay) * ctx.frames \
        / (us / 1e3)
