"""mcptam_tpu_torch — the multi-camera tracker ported to PyTorch and CUDA.

The port sits beside the JAX package ``mcptam_tpu`` (the reference it is
held against) and mirrors its layout: ``core/``, ``ops/``, ``map/``,
``tracker/``, ``system/`` and ``io/`` keep the JAX module and function
names.  It imports torch and never jax or ``mcptam_tpu``.

Kernels: the reference's Pallas kernels on the tracking path are
hand-written CUDA C++ kernels for Hopper under ``csrc/``, built with nvcc
at first use (``csrc/_build.py``).  Each wrapper takes its plain PyTorch
version for a CPU tensor and launches its kernel for a CUDA tensor, with
no fallback between the two.
"""

__version__ = "0.1.0"

import torch as _torch

# The reference forces highest-precision f32 matmuls (mcptam_tpu/__init__.py);
# geometry chains and the ZMSSD cross-correlation need full f32.  cuDNN's
# TF32 flag defaults to True, so both are set.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
