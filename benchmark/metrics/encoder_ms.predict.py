"""Device milliseconds a chunk spends in the 2D encoder: the CUDA-event
time of the program's ``predict.encode`` spans (normalize and
``encode_2d``, every data share) outside the carry bootstrap, over the
program's ``chunks`` counter. Nothing where the program records no spans
or an event has not completed."""

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
    encodes = [s for s in rec.named("predict.encode")
               if all(a.name != "predict.bootstrap" for a in rec.ancestors(s))]
    chunks = rec.counter("chunks")
    if not encodes or not chunks or any(s.device_ms is None for s in encodes):
        return None
    return sum(s.device_ms for s in encodes) / chunks
