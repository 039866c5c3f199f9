"""Mean device ms a traced step of the program's span `coarse.offset` (the
hybrid's offset branch: the offset decoder, the concatenation of the
detached coarse depth, the fusion's two convolutions and BatchNorms, the
head), from its CUDA events' elapsed time (`harness.spans`); forward only,
its backward is in `engine.backward`. None where the program has no such
span."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("coarse.offset",), TRAIN_STEP)
