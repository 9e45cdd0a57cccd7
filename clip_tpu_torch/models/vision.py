"""CLIP vision tower: patch embedding, class token and positions, pre-LN,
the transformer stack, CLS pooling, post-LN, projection and optional L2
normalization (the JAX package's ``models/vision.py``).

The stride-p convolution over non-overlapping patches is one matmul over
the reshaped patches.

Pad-once (the JAX package's ``models/vision.py:84-111``): where the TPU's
flat attention kernel cannot take the sequence at S but can at S rounded up
to a multiple of 8, and d_head is a multiple of 64 or the layer weights are
int8, the sequence is padded once after the pre-LN and the whole stack runs
at the padded length with the pad keys masked (``valid_len``).  The port's
kernels would run the unpadded S too, but the padded length changes which
W8A8 route the JAX package takes, and so the function computed: ViT-L/14-336
runs S = 584 (valid 577), which sends its attention to the staged route;
ViT-B/16, L/14 and H/14 run S = 200 or 264.  Real rows are unchanged by the
padding itself (masked keys give exactly 0 after the softmax) and CLS
pooling reads row 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import flat_eligible
from ..ops.linear import qmatmul
from ..ops.nn import l2_normalize, layernorm
from ..ops.qtensor import QTensor, W8Tensor, dequant, take_rows
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


def pad_once(b: int, s: int, cfg: VisionConfig, is_w8: bool) -> int:
    """The sequence length the stack runs at for ``b`` images of ``s`` tokens
    (``s`` itself where no padding applies)."""
    h3 = 3 * cfg.hidden_size
    if not flat_eligible(b, s, h3) and (cfg.d_head % 64 == 0 or is_w8):
        sp = -(-s // 8) * 8
        if sp != s and flat_eligible(b, sp, h3):
            return sp
    return s


def encode_image(params: dict, cfg: VisionConfig, pixels: torch.Tensor, *, use_gelu: bool,
                 normalize: bool = True, compute_dtype=torch.float32,
                 kernels: bool = True, **flags) -> torch.Tensor:
    """``pixels [B, S, S, 3]`` float NHWC, normalized -> embeddings ``[B, D]``.
    ``flags`` choose among the W8A8 routes (``models.transformer.block``)."""
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

    s = x.shape[1]
    sp = pad_once(b, s, cfg, isinstance(params["layers"]["qkv_w"], W8Tensor))
    if sp != s:
        x = F.pad(x, (0, 0, 0, sp - s))
    x = run_blocks(x, params["layers"], n_head=cfg.n_head, eps=cfg.eps, use_gelu=use_gelu,
                   causal=False, valid_len=s if sp != s else None, kernels=kernels, **flags)

    pooled = layernorm(x[:, 0, :], params["post_ln_w"], params["post_ln_b"], cfg.eps)
    out = qmatmul(pooled, params["proj"], compute_dtype=compute_dtype, kernels=kernels)
    return l2_normalize(out) if normalize else out
