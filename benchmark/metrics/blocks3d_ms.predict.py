"""Device milliseconds a chunk spends in the 3D head's four 3D blocks: the
CUDA-event time of the program's ``head.blocks3d`` spans outside the carry
bootstrap, over the program's ``chunks`` counter. Nothing where the program
records no such span or an event has not completed."""

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
    blocks = [s for s in rec.named("head.blocks3d")
              if all(a.name != "predict.bootstrap" for a in rec.ancestors(s))]
    chunks = rec.counter("chunks")
    if not blocks or not chunks or any(s.device_ms is None for s in blocks):
        return None
    return sum(s.device_ms for s in blocks) / chunks
