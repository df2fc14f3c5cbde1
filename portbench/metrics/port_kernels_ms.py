"""port_kernels_ms — kernels: device ms a frame of the port's own CUDA
kernels (K1 cluster raster, K2/K3 shadow sweeps, K4 and the other walks,
K9/K10 list rasters), taken by name from the device trace."""

from portbench.trace import is_port_kernel


def read(ctx):
    if not ctx.frames:
        return None
    us = sum(e - s for name, s, e, _ in ctx.device if is_port_kernel(name))
    if us <= 0:
        return None
    return us / 1e3 / ctx.frames
