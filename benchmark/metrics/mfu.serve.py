"""% of the card's bf16 peak that the window's answered requests are worth:
model FLOPs of a forward × completed requests ÷ the window ÷ the published
peak (the ladder's padding rows are not counted)."""

from flops import model_flops


def read(ctx):
    w, peak = ctx["window"], ctx.get("peak")
    if not peak or not w.get("completed"):
        return None
    return 100.0 * w["completed"] * model_flops(ctx["cfg"]) / w["seconds"] / peak["bf16"]
