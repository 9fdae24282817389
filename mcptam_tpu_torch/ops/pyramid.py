"""Image pyramid (port of mcptam_tpu/ops/pyramid.py, ref CVD::halfSample,
src/KeyFrame.cc:177-193).

Pyramid values are dyadic averages of the level-0 pixels, so for uint8
frames every level is exact in f32 and matches the reference bit for bit.
``half_sample`` runs the hand-written kernel ``csrc/halfsample.cu`` (K6/K7)
on a CUDA tensor and its plain version on a CPU one; both sum in the same
order, so they agree bit for bit on any f32 input.
"""

from __future__ import annotations

import numpy as np
import torch

from mcptam_tpu_torch.config import LEVELS
from mcptam_tpu_torch.ops.halfsample_kernel import half_sample_kernel


def half_sample(img: torch.Tensor) -> torch.Tensor:
    """2x2 average downsample of (...,H,W) f32 -> (...,H//2,W//2)."""
    if img.device.type == "cpu":
        return half_sample_reference(img)
    return half_sample_kernel(img.contiguous())


def half_sample_reference(img: torch.Tensor) -> torch.Tensor:
    """Plain version: (((a + b) + c) + d) * 0.25 over each 2x2 block, with
    a = (0,0), b = (0,1), c = (1,0), d = (1,1); an odd last row or column
    is dropped."""
    H, W = img.shape[-2], img.shape[-1]
    img = img[..., : H - H % 2, : W - W % 2]
    a = img[..., 0::2, 0::2]
    b = img[..., 0::2, 1::2]
    c = img[..., 1::2, 0::2]
    d = img[..., 1::2, 1::2]
    return (a + b + c + d) * 0.25


def build_pyramid(img_l0: torch.Tensor, levels: int = LEVELS):
    """Tuple of ``levels`` images, level 0 first."""
    pyr = [img_l0.to(torch.float32)]
    for _ in range(levels - 1):
        pyr.append(half_sample(pyr[-1]))
    return tuple(pyr)


def gaussian_blur_3(img: torch.Tensor, sigma: float = 2.5,
                    radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur on (...,H,W) with edge clamping
    (src/SmallBlurryImage.cc:67-95)."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    taps = [float(v) for v in k.astype(np.float32)]

    def conv_last(a):
        n = a.shape[-1]
        idx = torch.clamp(torch.arange(-radius, n + radius, device=a.device),
                          0, n - 1)
        ap = a[..., idx]
        out = torch.zeros_like(a)
        for i in range(2 * radius + 1):
            out = out + taps[i] * ap[..., i : i + n]
        return out

    img = conv_last(img)
    return conv_last(img.transpose(-1, -2)).transpose(-1, -2)
