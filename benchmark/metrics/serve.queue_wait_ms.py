"""Mean ms a request waited in the micro-batcher's queue, from its enqueue
to the collector taking it: the program's accumulator `serve.queue_wait`,
over every request the process served (warm-up, window and traced
stretch, all at the cell's rate; `harness.spans`)."""

from harness.spans import accumulated


def read(ctx):
    total = accumulated(ctx, "serve.queue_wait")
    return None if total is None else 1e3 * total[1] / total[0]
