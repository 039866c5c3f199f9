"""% of its bound that B3, the flash attention backward, reaches over the traced
calls of `audiodepth::flash_cross_attention_bwd` (`harness.readings.roofline`)."""

from harness.readings import roofline


def read(ctx):
    return roofline(ctx, "audiodepth::flash_cross_attention_bwd")
