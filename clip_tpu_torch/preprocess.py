"""CLIP image preprocessing: PIL-parity bicubic resize, center crop, normalize.

Reproduces the reference pipeline (upstream clip.cpp:728-927): a
two-pass separable bicubic resample (a = -0.5) with PIL's precomputed
coefficient windows, aspect-preserving resize of the short side to
``image_size``, center crop, and ``(x/255 - mean) / std`` normalization.

The per-output-pixel coefficient windows are materialized as dense
resampling *matrices*, so a resize is two matmuls — ``M_v @ img @ M_h^T`` —
which vectorizes in numpy on the host.  This is the host path only; the
device-side preprocess of the JAX package is not ported yet.
"""

from __future__ import annotations

import concurrent.futures as _futures
from functools import lru_cache

import numpy as np

__all__ = [
    "bicubic_filter",
    "resample_matrix",
    "resize_bicubic",
    "preprocess",
    "preprocess_batch",
    "resize_dims",
    "load_image",
]


def bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with a = -0.5 (PIL's BICUBIC, clip.cpp:728-741)."""
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


@lru_cache(maxsize=256)
def resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) float32 bicubic resampling matrix.

    Row ``xx`` holds PIL's normalized coefficient window for output pixel
    ``xx`` (clip.cpp:743-794); applying the matrix is exactly the reference's
    weighted sum, just expressed as a matmul.
    """
    support = 2.0
    filterscale = max(in_size / out_size, 1.0)
    support *= filterscale
    ss = 1.0 / filterscale

    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size)
    xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((centers + support + 0.5).astype(np.int64), in_size)

    m = np.zeros((out_size, in_size), dtype=np.float64)
    cols = np.arange(in_size, dtype=np.float64)
    w = bicubic_filter((cols[None, :] - centers[:, None] + 0.5) * ss)
    mask = (cols[None, :] >= xmin[:, None]) & (cols[None, :] < xmax[:, None])
    w = np.where(mask, w, 0.0)
    norm = w.sum(axis=1, keepdims=True)
    m = np.divide(w, norm, out=np.zeros_like(w), where=norm != 0.0)
    return m.astype(np.float32)


def resize_dims(nx: int, ny: int, image_size: int) -> tuple[int, int]:
    """Aspect-preserving target size with the short side == image_size,
    using the reference's rounding (clip.cpp:819-821)."""
    scale = min(nx, ny) / image_size
    return int(nx / scale + 0.5), int(ny / scale + 0.5)


def resize_bicubic(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Two-pass bicubic resize of an (H, W, C) image, clamping each pass to
    [0, 255] like the reference (clip.cpp:867,897).  Returns float32."""
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    mh = resample_matrix(w, out_w)
    mv = resample_matrix(h, out_h)
    # horizontal: (H, W, C) x (out_w, W)^T -> (H, out_w, C)
    tmp = np.einsum("hwc,ow->hoc", img, mh, optimize=True)
    np.clip(tmp, 0.0, 255.0, out=tmp)
    out = np.einsum("hwc,oh->owc", tmp, mv, optimize=True)
    np.clip(out, 0.0, 255.0, out=out)
    return out


def preprocess(
    img: np.ndarray,
    image_size: int,
    mean: np.ndarray,
    std: np.ndarray,
) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> normalized float32 (image_size, image_size, 3).

    Matches clip_image_preprocess (upstream clip.cpp:797-927): short
    side scaled to ``image_size``, center crop, ``(x/255 - mean)/std``.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    h, w = img.shape[:2]
    out_w, out_h = resize_dims(w, h, image_size)
    resized = resize_bicubic(img, out_w, out_h)
    x0 = (out_w - image_size) // 2
    y0 = (out_h - image_size) // 2
    crop = resized[y0 : y0 + image_size, x0 : x0 + image_size]
    mean = np.asarray(mean, dtype=np.float32).reshape(1, 1, 3)
    std = np.asarray(std, dtype=np.float32).reshape(1, 1, 3)
    return (crop / 255.0 - mean) / std


def preprocess_batch(
    images: list[np.ndarray],
    image_size: int,
    mean: np.ndarray,
    std: np.ndarray,
    n_workers: int = 4,
) -> np.ndarray:
    """Preprocess a batch on host threads (numpy matmuls release the GIL).

    Replaces the reference's pthread fan-out
    (upstream clip.cpp:963-1008).  Returns (B, S, S, 3) float32 NHWC.
    """
    if len(images) == 0:
        return np.zeros((0, image_size, image_size, 3), np.float32)
    if n_workers <= 1 or len(images) == 1:
        return np.stack([preprocess(im, image_size, mean, std) for im in images])
    with _futures.ThreadPoolExecutor(max_workers=min(n_workers, len(images))) as ex:
        outs = list(ex.map(lambda im: preprocess(im, image_size, mean, std), images))
    return np.stack(outs)


def load_image(path: str) -> np.ndarray:
    """Decode an image file to an RGB uint8 array.

    Replaces the reference's vendored stb_image decoder
    (upstream clip.cpp:709-726) with PIL.
    """
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
