"""Device milliseconds a chunk spends in PyTorch's elementwise kernels
(BN bias, activations, SE scales, casts; the profiler's kernels whose name
holds ``elementwise``)."""

LAYER = "models"
UNIT = "ms/chunk"
BETTER = "lower"
MOVES = "predict_fps"


def read(ctx):
    secs, launches = ctx.trace.kernel_seconds(lambda name: "elementwise" in name)
    if not launches or not ctx.chunks:
        return None
    return secs / ctx.chunks * 1e3
