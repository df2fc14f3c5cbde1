"""substep_kernels.crowd — simulation: device kernels one replay of the
crowd's substep graph runs: the kernels correlated with the graph launches
inside the ``portbench.substep`` spans, per launch."""


def read(ctx):
    return ctx.kernels_per_graph_launch("substep")
