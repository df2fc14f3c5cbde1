"""render_ms — render: the frame program's replay (extraction, geometry,
visibility, shading, composite, u8, overlay), by CUDA events recorded
around each ``FrameProgram.run`` of the traced window, mean in ms."""


def read(ctx):
    if not ctx.render_ms:
        return None
    return sum(ctx.render_ms) / len(ctx.render_ms)
