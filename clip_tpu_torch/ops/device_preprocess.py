"""Batched image preprocessing on the device (the JAX package's
``ops/device_preprocess.py:29-70``).

The bicubic resample is two dense float32 matmuls with PIL-exact coefficient
matrices (:func:`clip_tpu_torch.preprocess.resample_matrix`): horizontal,
clamp to [0, 255], vertical, clamp, then the center crop and the
normalization.  For a batch of same-sized uint8 images the host then ships
uint8 pixels (a quarter of the float32 bytes) and the whole preprocess runs
on the card ahead of the encode.  The JAX package leaves this to XLA (no
Pallas kernel), so it is plain PyTorch here.  The matmuls run in full
float32: TF32 is switched off around them, as ``precision="highest"`` asks
of the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..preprocess import resample_matrix, resize_dims

__all__ = ["device_preprocess", "make_device_preprocess"]


def make_device_preprocess(in_h: int, in_w: int, image_size: int, mean, std, device):
    """A function uint8 ``[B, in_h, in_w, 3]`` (on ``device``) -> float32
    ``[B, S, S, 3]`` normalized NHWC, for one input geometry."""
    out_w, out_h = resize_dims(in_w, in_h, image_size)
    mh = torch.from_numpy(resample_matrix(in_w, out_w)).to(device)
    mv = torch.from_numpy(resample_matrix(in_h, out_h)).to(device)
    mean = torch.as_tensor(np.asarray(mean, np.float32).reshape(1, 1, 1, 3), device=device)
    std = torch.as_tensor(np.asarray(std, np.float32).reshape(1, 1, 1, 3), device=device)
    x0 = (out_w - image_size) // 2
    y0 = (out_h - image_size) // 2

    def fn(imgs: torch.Tensor) -> torch.Tensor:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            x = imgs.to(torch.float32)
            x = torch.einsum("bhwc,ow->bhoc", x, mh).clamp(0.0, 255.0)
            x = torch.einsum("bhwc,oh->bowc", x, mv).clamp(0.0, 255.0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        x = x[:, y0:y0 + image_size, x0:x0 + image_size, :3]  # crop; RGBA drops alpha
        return (x / 255.0 - mean) / std

    return fn


def device_preprocess(imgs, image_size: int, mean, std, device="cpu") -> torch.Tensor:
    """One-shot helper: uint8 ``[B, H, W, 3]`` (numpy or tensor) -> normalized
    float32 ``[B, S, S, 3]`` on ``device``."""
    imgs = torch.as_tensor(np.asarray(imgs)).to(device)
    b, h, w, _ = imgs.shape
    return make_device_preprocess(h, w, image_size, mean, std, device)(imgs)
