"""Hand-written CUDA kernels of the port, one wrapper module each.

`KERNELS` lists every kernel wrapper with its source and the TPU kernel it
replaces (the BatchNorm pair replaces none); each wrapper keeps a
`launches` count of its calls.
"""

from . import batch_norm, flash_attention, fused_frontend

KERNELS = (
    (fused_frontend.fused_mel_frontend, fused_frontend.SOURCE, fused_frontend.REPLACES),
    (flash_attention.flash_cross_attention, flash_attention.SOURCE, flash_attention.REPLACES),
    (flash_attention.flash_cross_attention_bwd, flash_attention.SOURCE,
     flash_attention.REPLACES_BWD),
    (batch_norm.batch_norm_train_fwd, batch_norm.SOURCE, batch_norm.REPLACES),
    (batch_norm.batch_norm_train_bwd, batch_norm.SOURCE, batch_norm.REPLACES),
)
