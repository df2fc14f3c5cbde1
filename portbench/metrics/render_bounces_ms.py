"""render_bounces_ms — render: device ms a frame of the frame program's
stages ``sge.render.mirror`` and ``sge.render.refraction`` together (the
mirror and refraction bounces (K4 traces and their shading), less their
shadows): the nodes of those stages in the stage table the program keeps
for the graph, read from each replay inside the benchmark's
``portbench.frame_program`` spans (``portbench/stage_split.py``)."""

from portbench.stage_split import stage_ms


def read(ctx):
    return stage_ms(ctx, "frame_program", "sge.frame_program",
                    "sge.render.mirror", "sge.render.refraction")
