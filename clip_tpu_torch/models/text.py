"""CLIP text tower: token + position embeddings, causal blocks, final LN,
EOT pooling at each sequence's last real token, projection and optional L2
normalization (the JAX package's ``models/text.py``).

The context is padded once to a multiple of 16 (77 -> 80), as the JAX
package does.  Pad rows sit after every real token, so the causal mask
keeps them out of every real query (masked logits give exactly 0 after the
softmax) and EOT pooling reads real rows only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.linear import qmatmul
from ..ops.nn import l2_normalize, layernorm
from ..ops.qtensor import take_rows
from .config import TextConfig
from .transformer import run_blocks


def encode_text(params: dict, cfg: TextConfig, token_ids: torch.Tensor, lengths: torch.Tensor,
                *, use_gelu: bool, normalize: bool = True, compute_dtype=torch.float32,
                kernels: bool = True, **flags) -> torch.Tensor:
    """``token_ids [B, S]`` int (padded), ``lengths [B]`` true lengths
    (BOS and EOS included) -> embeddings ``[B, D]``.  ``flags`` choose among
    the W8A8 routes (``models.transformer.block``)."""
    b, s = token_ids.shape
    sp = -(-s // 16) * 16
    token_ids = F.pad(token_ids, (0, sp - s))

    x = take_rows(params["tok_embd"], token_ids, dtype=compute_dtype)
    pos = take_rows(params["pos_embd"], torch.arange(s, device=token_ids.device),
                    dtype=compute_dtype)
    pos = F.pad(pos, (0, 0, 0, sp - s))
    x = x + pos[None]

    x = run_blocks(x, params["layers"], n_head=cfg.n_head, eps=cfg.eps, use_gelu=use_gelu,
                   causal=True, kernels=kernels, **flags)
    x = layernorm(x, params["post_ln_w"], params["post_ln_b"], cfg.eps)

    pooled = x[torch.arange(b, device=x.device), lengths.to(torch.long) - 1]
    out = qmatmul(pooled, params["proj"], compute_dtype=compute_dtype, kernels=kernels)
    return l2_normalize(out) if normalize else out
