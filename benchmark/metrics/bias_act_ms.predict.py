"""Device milliseconds a chunk spends in the folded BN's epilogue kernel
(bias, SiLU and residual add in one pass; the profiler's kernels whose name
holds ``bias_act``). Nothing where the program has no such kernel."""

LAYER = "models"
UNIT = "ms/chunk"
BETTER = "lower"
MOVES = "predict_fps"


def read(ctx):
    secs, launches = ctx.trace.kernel_seconds(lambda name: "bias_act" in name)
    if not launches or not ctx.chunks:
        return None
    return secs / ctx.chunks * 1e3
