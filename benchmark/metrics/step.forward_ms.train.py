"""Mean device ms a traced step of the program's span `engine.forward`
(zero_grad, the task's step draw and the loss: B1, the net, B2, the loss),
from its CUDA events' elapsed time (`harness.spans`)."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("engine.forward",), TRAIN_STEP)
