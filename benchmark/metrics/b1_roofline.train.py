"""% of its bound that B1, the fused mel front end, reaches over the traced
calls of `audiodepth::fused_mel_frontend` (`harness.readings.roofline`)."""

from harness.readings import roofline


def read(ctx):
    return roofline(ctx, "audiodepth::fused_mel_frontend")
