"""Device-idle ms a traced step inside the program's `engine.train_step`
annotations: the card waiting on the step's own issue
(`harness.spans.idle_split`)."""

from harness.spans import idle_split


def read(ctx):
    split = idle_split(ctx)
    return None if split is None else split[0] / split[2]
