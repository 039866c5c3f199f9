"""Mean device ms a traced step of the program's span `loss.distillation`
(the five-term distillation loss's forward), from its CUDA events' elapsed
time (`harness.spans`); None where the program has no such span."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("loss.distillation",), TRAIN_STEP)
