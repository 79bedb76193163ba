"""Host milliseconds a chunk spends in the engine's ``put_new`` (the
synchronous upload of the chunk's padded uint8 frames from pageable
memory), from the benchmark's span around each call."""

LAYER = "host loop"
UNIT = "ms/chunk"
BETTER = "lower"
MOVES = "predict_fps"


def read(ctx):
    spans = ctx.spans.seconds.get("bench.upload", [])
    return sum(spans) / len(spans) * 1e3 if spans else None
