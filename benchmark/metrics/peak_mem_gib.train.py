"""GiB of device memory at the window's peak
(`torch.cuda.max_memory_allocated` after a reset before it), on the
fullest card."""


def read(ctx):
    peak = ctx["window"].get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
