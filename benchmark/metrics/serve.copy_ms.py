"""Mean device ms a traced batch of the runner's copies: the program's
spans `runner.h2d` (the recordings to the card) and `runner.d2h` (the
depth maps back), from their CUDA events' elapsed time, over the traced
batches (`runner.forward` spans; `harness.spans`)."""

from harness.spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("runner.h2d", "runner.d2h"), "runner.forward")
