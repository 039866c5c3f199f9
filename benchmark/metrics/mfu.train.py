"""% of the card's bf16 peak that the window's trained pairs are worth:
model FLOPs of a trained pair (3 × the forward, `flops.model`) × pairs ÷
the window's wall ÷ the cards ÷ the published peak."""

from flops import train_flops_per_pair


def read(ctx):
    w, peak = ctx["window"], ctx.get("peak")
    if not peak or not w.get("pairs"):
        return None
    return 100.0 * w["pairs"] * train_flops_per_pair(ctx["cfg"]) / w["seconds"] \
        / w["ranks"] / peak["bf16"]
