"""PyTorch + CUDA port of the stereo SLAM front end (``orb_slam3_fast_tpu``).

The JAX package is the reference; every module here mirrors one of its
modules and is held against it by the ``tests/test_torch_*.py`` parity tests.
The hot stages run as hand-written CUDA kernels (``csrc/``, built on first
use by ``_kernels.py``); each kernel's wrapper takes its plain PyTorch version
for a CPU tensor and launches the kernel, or raises, for a CUDA tensor.

This package imports ``torch`` and never ``jax``.
"""
import torch as _torch

# SLAM geometry lives in small 3x3 / 6x6 float32 products that TF32 (about
# three decimal digits) would break, as bf16 does on the TPU; the JAX package
# asks for "highest" matmul precision for the same reason.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
