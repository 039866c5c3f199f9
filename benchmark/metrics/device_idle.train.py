"""% of the traced window in which no GPU event ran (the busy union over
every stream), averaged over the cards."""

from harness.readings import idle_share


def read(ctx):
    return idle_share(ctx)
