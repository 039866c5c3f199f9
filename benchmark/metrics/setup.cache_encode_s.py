"""Host seconds of the program's span `cache.encode` in set-up: the device
cache's per-row encode to the compact dtypes and the stacking, from the
spans' accumulator (`harness.spans`)."""

from harness.spans import accumulated


def read(ctx):
    total = accumulated(ctx, "cache.encode")
    return None if total is None else total[1]
