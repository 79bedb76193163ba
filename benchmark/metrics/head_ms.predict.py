"""Device milliseconds a chunk spends in the 3D head: the CUDA-event time
of the program's ``predict.head`` spans (the windows, ``forward_3d_head``,
the sigmoid and the TTA mean, every data share), over the program's
``chunks`` counter. Nothing where the program records no spans or an event
has not completed."""

LAYER = "models"
UNIT = "ms/chunk"
BETTER = "lower"
MOVES = "predict_fps"


def read(ctx):
    try:
        from ball_action_spotting_torch.utils.profiling import records
    except ImportError:  # a program without the tracer
        return None
    rec = records()
    heads = rec.named("predict.head")
    chunks = rec.counter("chunks")
    if not heads or not chunks or any(s.device_ms is None for s in heads):
        return None
    return sum(s.device_ms for s in heads) / chunks
