"""substep_kernels.frame — simulation: device kernels one replay of the
substep graph runs, in the frame cells: the kernels correlated with the
graph launches inside the ``portbench.substeps`` spans, per launch."""


def read(ctx):
    return ctx.kernels_per_graph_launch("substeps")
