"""Mean device ms a traced step of the program's span `adabins.bins` (the
bin predictor and the softmax expectation over the bins), both branches'
entries summed (the teacher's lies inside `adabins.teacher` too), from
their CUDA events' elapsed time (`harness.spans`); None where the program
has no such span."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("adabins.bins",), TRAIN_STEP)
