"""CLIP vision tower: patch embedding, class token and positions, pre-LN,
the transformer stack, CLS pooling, post-LN, projection and optional L2
normalization (the JAX package's ``models/vision.py``).

The stride-p convolution over non-overlapping patches is one matmul over
the reshaped patches.  No sequence padding: the kernels of both routes run any
S (S = 50 at ViT-B/32), so the JAX package's pad-once to a multiple of 8 is
not needed (it masks the pad keys, so real rows are the same without it).
"""

from __future__ import annotations

import torch

from ..ops.linear import qmatmul
from ..ops.nn import l2_normalize, layernorm
from ..ops.qtensor import QTensor, dequant, take_rows
from .config import VisionConfig
from .transformer import run_blocks


def patch_embed(pixels: torch.Tensor, w4: torch.Tensor, patch: int) -> torch.Tensor:
    """``pixels [B, H, W, C]`` (NHWC) and the conv kernel ``[hidden, C, p, p]``
    -> ``[B, n_patches, hidden]`` as one matmul."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, patch * patch * c)
    wm = w4.permute(0, 2, 3, 1).reshape(w4.shape[0], patch * patch * c)
    return torch.matmul(x, wm.T)


def encode_image(params: dict, cfg: VisionConfig, pixels: torch.Tensor, *, use_gelu: bool,
                 normalize: bool = True, compute_dtype=torch.float32,
                 kernels: bool = True) -> torch.Tensor:
    """``pixels [B, S, S, 3]`` float NHWC, normalized -> embeddings ``[B, D]``."""
    b = pixels.shape[0]
    w_patch = params["patch_embd"]
    if isinstance(w_patch, QTensor):
        w_patch = dequant(w_patch, dtype=compute_dtype)
    x = patch_embed(pixels.to(compute_dtype), w_patch.to(compute_dtype), cfg.patch_size)

    cls = params["class_embd"].to(compute_dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    pos = take_rows(params["pos_embd"],
                    torch.arange(cfg.num_positions, device=x.device), dtype=compute_dtype)
    x = x + pos[None]
    x = layernorm(x, params["pre_ln_w"], params["pre_ln_b"], cfg.eps)

    x = run_blocks(x, params["layers"], n_head=cfg.n_head, eps=cfg.eps, use_gelu=use_gelu,
                   causal=False, kernels=kernels)

    pooled = layernorm(x[:, 0, :], params["post_ln_w"], params["post_ln_b"], cfg.eps)
    out = qmatmul(pooled, params["proj"], compute_dtype=compute_dtype, kernels=kernels)
    return l2_normalize(out) if normalize else out
