"""Hand-written CUDA kernels of the port, one wrapper module each.

`KERNELS` lists every kernel wrapper with the TPU kernel it replaces; each
wrapper keeps a `launches` count of its kernel launches.
"""

from . import fused_frontend

KERNELS = (
    (fused_frontend.fused_mel_frontend, fused_frontend.SOURCE, fused_frontend.REPLACES),
)
