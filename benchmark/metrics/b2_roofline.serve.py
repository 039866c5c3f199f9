"""% of its bound that B2, the flash attention forward, reaches over the traced
calls of `audiodepth::flash_cross_attention_fwd` (`harness.readings.roofline`)."""

from harness.readings import roofline


def read(ctx):
    return roofline(ctx, "audiodepth::flash_cross_attention_fwd")
