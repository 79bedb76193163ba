"""Host milliseconds a chunk spends taking and padding its frames: the
self time of the program's ``predict.pad`` spans after each segment's carry
bootstrap (one a chunk), over the program's ``chunks`` counter. Nothing
where the program records no spans."""

LAYER = "host loop"
UNIT = "ms/chunk"
BETTER = "lower"
MOVES = "predict_fps"


def read(ctx):
    try:
        from ball_action_spotting_torch.utils.profiling import records
    except ImportError:  # a program without the tracer
        return None
    rec = records()
    booted = {s.request: s.end_ns for s in rec.named("predict.bootstrap")}
    pads = [s for s in rec.named("predict.pad")
            if s.request in booted and s.start_ns >= booted[s.request]]
    chunks = rec.counter("chunks")
    if not pads or not chunks:
        return None
    return sum(rec.self_ns(s) for s in pads) / chunks / 1e6
