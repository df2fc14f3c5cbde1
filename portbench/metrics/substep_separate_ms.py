"""substep_separate_ms — simulation: device ms a replay of the substep
graph's stage ``sge.substep.separate`` (agent separation): the nodes of that
stage in the stage table the program keeps for the graph, read from each
replay inside the benchmark's ``portbench.substeps`` spans
(``portbench/stage_split.py``)."""

from portbench.stage_split import stage_ms


def read(ctx):
    return stage_ms(ctx, "substeps", "sge.substep", "sge.substep.separate")
