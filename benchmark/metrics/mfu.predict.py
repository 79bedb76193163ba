"""The whole prediction's share of the card's bf16 peak: the FLOPs a
predicted frame needs (``counts.predict_frame_flops``: one new stack
encoded and one window's 3D head, each view) times the frames predicted in
the traced window, over the window's length and 989 TFLOP/s."""

from benchmark import counts

LAYER = "chunk program"
UNIT = "%"
BETTER = "higher"
MOVES = "predict_fps"


def read(ctx):
    if not ctx.frames or ctx.trace.window_s <= 0:
        return None
    return ctx.frame_flops * ctx.frames / ctx.trace.window_s / counts.PEAK_BF16_FLOP_S * 100.0
