"""Tensor ops of the port: STFT/mel, resize, and the CUDA kernels."""
