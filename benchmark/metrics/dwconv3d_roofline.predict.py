"""The depthwise 3x3x3 kernel's share of its roofline: its byte bound
(``counts.dwconv3d_bytes`` at a chunk head's shape, input read once,
output written once, at 3.35 TB/s) times its launches, over its device
time in the trace."""

from benchmark import counts

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "predict_fps"


def read(ctx):
    secs, launches = ctx.trace.kernel_seconds(lambda name: "dwconv3d_kernel" in name)
    if not launches or secs <= 0:
        return None
    return launches * counts.bound_s(nbytes=ctx.dwconv3d_bytes) / secs * 100.0
