"""Device-idle ms a traced step outside every `engine.train_step`
annotation, inside the traced window: the bubble at the step's boundary
(the feed, the loop, the Python between steps; `harness.spans.idle_split`)."""

from harness.spans import idle_split


def read(ctx):
    split = idle_split(ctx)
    return None if split is None else split[1] / split[2]
