"""The share of the windows the chunk program computes whose predictions
the engine keeps: the program's ``predictions_kept`` over its
``windows_computed`` counter (a segment's last chunk is padded past its
end). Nothing where the program counts nothing."""

LAYER = "chunk program"
UNIT = "%"
BETTER = "higher"
MOVES = "predict_fps"


def read(ctx):
    try:
        from ball_action_spotting_torch.utils.profiling import records
    except ImportError:  # a program without the tracer
        return None
    rec = records()
    computed = rec.counter("windows_computed")
    if not computed:
        return None
    return rec.counter("predictions_kept") / computed * 100.0
