"""The benchmark's frozen yardstick of work: model FLOPs, kernel bounds and
the card's peaks. Later changes to the program cannot move it.

Model FLOPs (`model_flops`) are 2 × the multiply-adds of every
convolution, transposed convolution, linear layer (the attention's 1×1
projections) and attention product (q·kᵀ and p·v, both directions) of one
pair's forward, worked out in closed form from the configuration's shapes
by the family's file, `families/<family>.py`. The front end's small
products (about 1 % of a UNet pair) are not model FLOPs. A trained pair
counts 3 × its forward unless the family's file says otherwise;
recomputation (the binaural encoders' remat, B3's recompute of the scores)
is never counted.

Kernel bounds (`kernel_bound_s`) are `chip_smoke.py`'s arithmetic, frozen,
an op's in its file `bounds/<op name after "::">.py`: the least time of one
call of a hand-written op, the larger of its operations at the peak rate
for them and its bytes (each input read once, each output written once) at
the memory's rate.

A family's FLOPs and a kernel's bound join as new files: no file here
outside `families/` and `bounds/` names a family or an op.
"""

from .bounds import bounded_ops
from .kernels import kernel_bound_s
from .model import model_flops, train_flops_per_pair
from .peaks import PEAKS, peak_for

__all__ = ["PEAKS", "bounded_ops", "kernel_bound_s", "model_flops", "peak_for",
           "train_flops_per_pair"]
