"""render_continuations_ms — render: device ms a frame of the frame
program's stage ``sge.render.continuations`` (the shade of layers 2.., less
the shadows and bounces inside it): the nodes of that stage in the stage
table the program keeps for the graph, read from each replay inside the
benchmark's ``portbench.frame_program`` spans
(``portbench/stage_split.py``)."""

from portbench.stage_split import stage_ms


def read(ctx):
    return stage_ms(ctx, "frame_program", "sge.frame_program",
                    "sge.render.continuations")
