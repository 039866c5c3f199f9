"""Mean device ms a traced step of the step's input: the program's spans
`cache.gather` (the batch's rows gathered from the device cache) and
`engine.decode` (the batch put on the card and decoded), each from its
CUDA events' elapsed time (`harness.spans`)."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("cache.gather", "engine.decode"), TRAIN_STEP)
