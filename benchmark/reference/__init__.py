"""The benchmark's plain reference: float32 PyTorch with TF32 off.

Frozen copies of the mel front end, UNet-256, the binaural attention net
(plain blockwise attention), the Combined loss, the global-norm clip and
AdamW. It imports only torch, numpy and the standard library, and nothing
of the program under test: it takes the benchmark's weights and inputs and
works out for itself everything the program derives from them.

`Precision` decides how the nets' products run: float32 (the reference), or
the float8 control (`Precision.fp8()`), the step below the configuration's
bfloat16 that would tempt a later change, which must come out as not
correct.
"""

from .frontend import mel_frontend, tof_cut_samples
from .nets import build_net, param_specs
from .precision import Precision
from .train import clipped_grads, combined_loss, reference_steps

__all__ = ["Precision", "build_net", "clipped_grads", "combined_loss", "mel_frontend",
           "param_specs", "reference_steps", "tof_cut_samples"]
