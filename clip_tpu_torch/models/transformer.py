"""Shared CLIP transformer block over stacked layer parameters.

Numerics mirror the JAX package's ``models/transformer.py``: pre-LN ->
attention (Q pre-scaled by 1/sqrt(d_head)) -> residual -> pre-LN -> MLP
(quick-gelu or tanh-gelu) -> residual.  Only the fused W8A8 route is ported:
``lnq_fuse=True, attn_block=True, mlp_full=True`` with per-channel int8
layer weights, where each half of a layer is one block kernel
(``ops.attention.attn_block``, ``ops.actquant.mlp_lnq``) that also adds the
bias and the residual.  Other routes raise ``NotImplementedError``.

``kernels=False`` runs the blocks' plain PyTorch versions on any device: the
reference the kernels are held against on a card.
"""

from __future__ import annotations

from ..ops.actquant import mlp_lnq, mlp_lnq_plain
from ..ops.attention import attn_block, attn_block_plain
from ..ops.qtensor import W8Tensor


def _check_route(lp, lnq_fuse: bool, attn_block_route: bool, mlp_full: bool) -> None:
    if not (lnq_fuse and attn_block_route and mlp_full):
        raise NotImplementedError(
            "only the fused W8A8 route (lnq_fuse, attn_block, mlp_full) is ported")
    if not all(isinstance(lp[k], W8Tensor) for k in ("qkv_w", "o_w", "up_w", "down_w")):
        raise NotImplementedError("the fused route needs per-channel int8 layer weights")


def attention(x, lp, *, n_head: int, eps: float, causal: bool = False,
              valid_len: int | None = None, kernels: bool = True):
    """``x + attn(ln1(x))`` over the raw residual stream ``x [B, S, H]``."""
    h = x.shape[-1]
    d_head = h // n_head
    qkv_width = lp["qkv_w"].shape[0]
    fn = attn_block if kernels else attn_block_plain
    return fn(x, lp["ln1_w"], lp["ln1_b"], lp["qkv_w"].c8, lp["qkv_w"].ws, lp["qkv_b"],
              lp["o_w"].c8, lp["o_w"].ws, lp["o_b"],
              n_head=qkv_width // 3 // d_head, scale=1.0 / d_head ** 0.5, eps=eps,
              causal=causal, valid_len=valid_len)


def block(x, lp, *, n_head: int, eps: float, use_gelu: bool, causal: bool = False,
          valid_len: int | None = None, lnq_fuse: bool = True, attn_block: bool = True,
          mlp_full: bool = True, kernels: bool = True):
    _check_route(lp, lnq_fuse, attn_block, mlp_full)
    x = attention(x, lp, n_head=n_head, eps=eps, causal=causal, valid_len=valid_len,
                  kernels=kernels)
    b, s, h = x.shape
    fn = mlp_lnq if kernels else mlp_lnq_plain
    y = fn(x.reshape(b * s, h), lp["ln2_w"], lp["ln2_b"],
           lp["up_w"].c8, lp["up_w"].ws, lp["up_b"],
           lp["down_w"].c8, lp["down_w"].ws, lp["down_b"],
           eps=eps, act="gelu_tanh" if use_gelu else "gelu_quick")
    return y.reshape(b, s, h)


def layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked ``[L, ...]`` parameters (views, no copy)."""
    return {k: v[i] for k, v in layers.items()}


def run_blocks(x, layers: dict, *, n_head: int, eps: float, use_gelu: bool,
               causal: bool = False, valid_len: int | None = None, lnq_fuse: bool = True,
               attn_block: bool = True, mlp_full: bool = True, kernels: bool = True):
    """Run the transformer stack; ``layers`` leaves carry a leading L axis.
    A Python loop takes the place of the JAX package's ``lax.scan``."""
    for i in range(layers["ln1_w"].shape[0]):
        x = block(x, layer(layers, i), n_head=n_head, eps=eps, use_gelu=use_gelu,
                  causal=causal, valid_len=valid_len, lnq_fuse=lnq_fuse,
                  attn_block=attn_block, mlp_full=mlp_full, kernels=kernels)
    return x
