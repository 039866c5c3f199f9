"""Mean device ms a traced step of the program's span `coarse.bins` (the
coarse model's soft binning: the softmax expectation of the class head's
float32 logits over the fixed bin centres), from its CUDA events' elapsed
time (`harness.spans`); forward only, its backward is in `engine.backward`.
None where the program has no such span."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("coarse.bins",), TRAIN_STEP)
