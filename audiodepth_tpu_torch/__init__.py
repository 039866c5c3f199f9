"""audiodepth_tpu_torch — the PyTorch + CUDA port of audiodepth_tpu.

Binaural chirp-echo waveforms → metric depth maps on an NVIDIA Hopper card.
The JAX package (`audiodepth_tpu`) is the reference; each module here
mirrors its counterpart's path and is held against it by the
`tests/test_torch_*.py` parity tests.

Rules the package keeps:
  * it imports torch and numpy (scipy for the Python WAV decoder), never
    jax/flax/optax or `audiodepth_tpu`, and needs neither pandas, OpenCV
    nor matplotlib to train (matplotlib only to draw);
  * entry points (`make_task`, `InferenceRunner`, `cli.serve`, `cli.train`,
    `cli.evaluate`) run on
    ``cuda`` unless the caller passes ``device="cpu"``, and raise when no
    card is present rather than carrying on on the CPU;
  * every Pallas kernel of the JAX package on a ported path is a CUDA C++
    kernel under `csrc/`, built at first use by `ops/cuda/_build.py`; its
    wrapper takes the plain PyTorch version only for a tensor the caller
    put on the CPU;
  * public functions keep the JAX package's layouts (NHWC front-end output,
    `[B, S, S, 1]` predictions); the UNet runs NCHW inside.
"""

__version__ = "0.1.0"
