"""Rows a device batch carried over the window: the micro-batcher's
`served` over its `batches`, both counted between the window's ends."""


def read(ctx):
    w = ctx["window"]
    return w["served_rows"] / w["batches"] if w.get("batches") else None
