"""Elementwise and normalization primitives: the plain reference math that
every kernel of the port is held to.

Each function repeats the JAX package's arithmetic in the same order, in
float32, so that the plain versions of the kernels agree with the Pallas
kernels to float32 rounding.
"""

from __future__ import annotations

import torch

_SQRT_2_OVER_PI = 0.7978845608028654


def layernorm_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """ggml_norm + affine in float32 with one-pass moments (E[x^2] - mu^2).

    The variance is clamped at 0: the one-pass form can cancel slightly
    negative for near-constant rows, and rsqrt of a negative number would be
    NaN (the JAX package's ``actquant_pallas.py:86-89``).  Returns float32:
    the LN + quant prologue of the block kernels quantizes this value
    without rounding it to the compute dtype first."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp(ms - mu * mu, min=0.0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y * w.to(torch.float32) + b.to(torch.float32)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`layernorm_f32` rounded to the dtype of ``x``."""
    return layernorm_f32(x, w, b, eps).to(x.dtype)


def gelu_quick(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), written through sigmoid(z) = 0.5 + 0.5 tanh(z/2)
    as the JAX package writes it in every path."""
    y = x.to(torch.float32)
    y = y * (0.5 + 0.5 * torch.tanh(0.851 * y))
    return y.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """ggml_gelu: tanh-approximated GELU, in the order of the MLP kernel."""
    y = x.to(torch.float32)
    y = 0.5 * y * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (y + 0.044715 * y * y * y)))
    return y.to(x.dtype)


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: ``[M, K]`` -> (codes int8
    ``[M, K]``, scales float32 ``[M]``).  ``amax/127 + 1e-12``, round half to
    even (``torch.round``), clip to +-127."""
    x2 = x.to(torch.float32)
    amax = x2.abs().amax(dim=-1)
    sx = amax / 127.0 + 1e-12
    codes = torch.clamp(torch.round(x2 / sx[:, None]), -127, 127).to(torch.int8)
    return codes, sx


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    x32 = x.to(torch.float32)
    inv = torch.reciprocal(torch.sqrt((x32 * x32).sum(dim=dim, keepdim=True)))
    return (x32 * inv).to(x.dtype)
