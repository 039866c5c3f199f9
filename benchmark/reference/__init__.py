"""The benchmark's plain reference: float32 PyTorch with TF32 off.

Frozen copies of the mel front end, the layers the families share, each
model family's net, loss and initialisation (a file each, found by name:
`families/<family>.py`, which sets out what such a file provides), the
Combined loss, the global-norm clip and AdamW. It imports only torch,
numpy and the standard library, and nothing of the program under test: it
takes the benchmark's weights and inputs and works out for itself
everything the program derives from them. No file of the reference outside
`families/` names a family: a family joins by a new file.

`Precision` decides how the nets' products run: float32 (the reference), or
the float8 control (`Precision.fp8()`), the step below the configuration's
bfloat16 that would tempt a later change, which must come out as not
correct.
"""

from .families import build_net, family, param_specs
from .frontend import mel_frontend, tof_cut_samples
from .precision import Precision
from .train import clipped_grads, combined_loss, reference_steps

__all__ = ["Precision", "build_net", "clipped_grads", "combined_loss", "family",
           "mel_frontend", "param_specs", "reference_steps", "tof_cut_samples"]
