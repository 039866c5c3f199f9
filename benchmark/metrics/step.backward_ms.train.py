"""Mean device ms a traced step of the program's span `engine.backward`
(`loss.backward()`: B3 and remat's recompute), from its CUDA events'
elapsed time (`harness.spans`)."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("engine.backward",), TRAIN_STEP)
