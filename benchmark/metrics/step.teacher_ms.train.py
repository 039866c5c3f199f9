"""Mean device ms a traced step of the program's span `adabins.teacher`
(the frozen camera teacher's whole forward under no_grad, its bin
predictor and soft binning included), from its CUDA events' elapsed time
(`harness.spans`); None where the program has no such span."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("adabins.teacher",), TRAIN_STEP)
