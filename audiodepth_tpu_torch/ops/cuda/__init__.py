"""Hand-written CUDA kernels of the port, one wrapper module each.

`KERNELS` lists every kernel wrapper with its source and the TPU kernel it
replaces (the BatchNorm pair and the soft-binning pair replace none); each
wrapper derives from `_build.Launcher`, which keeps a `launches` count of
its calls. A module here decides which tensors its kernels take: the model
calls its entry (`cross_attention`, `soft_binning`, the front end's op) or
its `kernel_takes` (BatchNorm), and no module outside `ops/` reads its
constants.
"""

from . import batch_norm, flash_attention, fused_frontend, soft_binning

KERNELS = (
    (fused_frontend.fused_mel_frontend, fused_frontend.SOURCE, fused_frontend.REPLACES),
    (flash_attention.flash_cross_attention, flash_attention.SOURCE, flash_attention.REPLACES),
    (flash_attention.flash_cross_attention_bwd, flash_attention.SOURCE,
     flash_attention.REPLACES_BWD),
    (batch_norm.batch_norm_train_fwd, batch_norm.SOURCE, batch_norm.REPLACES),
    (batch_norm.batch_norm_train_bwd, batch_norm.SOURCE, batch_norm.REPLACES),
    (soft_binning.soft_binning_fwd, soft_binning.SOURCE, soft_binning.REPLACES),
    (soft_binning.soft_binning_bwd, soft_binning.SOURCE, soft_binning.REPLACES),
)
