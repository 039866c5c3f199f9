"""Mean wall ms of one `InferenceRunner.run` in the window: a span the
benchmark puts around each call (host to device, the forward, the answer's
copy back)."""

from statistics import fmean


def read(ctx):
    spans = ctx["window"].get("runner_s")
    return 1e3 * fmean(spans) if spans else None
