"""Mean device ms a traced step of the program's span `engine.optimizer`
(the gradient norm, the clip, the learning rate and AdamW), from its CUDA
events' elapsed time (`harness.spans`)."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("engine.optimizer",), TRAIN_STEP)
