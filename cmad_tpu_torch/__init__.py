"""cmad_tpu_torch — the PyTorch and CUDA port of cmad_tpu.

The JAX package ``cmad_tpu`` is the reference; this package re-implements
its J2+Voce return-map path in plain PyTorch and runs it on an NVIDIA
Hopper card through hand-written CUDA kernels (``csrc/``):

- float64 is the default on CPU and CUDA alike (``config.DEFAULT_DTYPE``);
  float32 is an opt-in argument
- every function runs on the device its input tensors live on; a CUDA
  tensor goes through the CUDA kernel or the call raises

This package imports neither ``jax`` nor ``cmad_tpu``.
"""
from cmad_tpu_torch import config as _config

_config.setup()

__version__ = "0.1.0"
