"""Mean device ms a traced step of the program's span `loss.coarse` (the
coarse family's loss; the hybrid's: the label-smoothed float32 cross
entropy over the bins, the L1 of the final depth, the offset's L1), from
its CUDA events' elapsed time (`harness.spans`); forward only, its backward
is in `engine.backward`. None where the program has no such span."""

from harness.spans import TRAIN_STEP, device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("loss.coarse",), TRAIN_STEP)
