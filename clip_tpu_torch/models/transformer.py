"""Shared CLIP transformer block over stacked layer parameters.

Numerics mirror the JAX package's ``models/transformer.py``: pre-LN ->
attention (Q pre-scaled by 1/sqrt(d_head)) -> residual -> pre-LN -> MLP
(quick-gelu or tanh-gelu) -> residual.  The route follows the layer weights'
type, as in the JAX package (:func:`route`):

* ``"w8a8"``: per-channel int8 layer weights (re-quantized from a
  block-quantized checkpoint) take the fused route, ``lnq_fuse=True,
  attn_block=True, mlp_full=True``, where each half of a layer is one block
  kernel (``ops.attention.attn_block``, ``ops.actquant.mlp_lnq``) that also
  adds the bias and the residual.  The staged W8A8 routes (any of those
  flags off) are not ported and raise ``NotImplementedError``.
* ``"dense"``: dense (f16/f32-sourced) layer weights take the JAX package's
  dense route (``transformer.py:232-299, 426-437``): LN -> qkv GEMM + bias
  -> ``ops.attention.mha_qkv`` -> o GEMM + bias -> residual, then LN -> up
  GEMM + bias -> gelu -> down GEMM -> + bias -> residual.  The GEMMs are
  ``torch.matmul`` in the compute dtype (the JAX package leaves them to
  XLA); each bias and the residual is added in the compute dtype after the
  GEMM's rounding, as the JAX package adds them.

``kernels=False`` runs the plain PyTorch versions on any device: the
reference the kernels are held against on a card.
"""

from __future__ import annotations

from ..ops.actquant import mlp_lnq, mlp_lnq_plain
from ..ops.attention import attn_block, attn_block_plain, mha_qkv, mha_qkv_plain
from ..ops.linear import qmatmul
from ..ops.nn import gelu_quick, gelu_tanh, layernorm
from ..ops.qtensor import W8Tensor

_LAYER_WEIGHTS = ("qkv_w", "o_w", "up_w", "down_w")


def route(layers: dict) -> str:
    """``"w8a8"`` for per-channel int8 layer weights, ``"dense"`` for dense
    tensors; a mix raises."""
    w8 = [isinstance(layers[k], W8Tensor) for k in _LAYER_WEIGHTS]
    if all(w8):
        return "w8a8"
    if not any(w8):
        return "dense"
    raise NotImplementedError("layer weights mix int8 and dense tensors")


def _check_w8a8_flags(lnq_fuse: bool, attn_block_route: bool, mlp_full: bool) -> None:
    if not (lnq_fuse and attn_block_route and mlp_full):
        raise NotImplementedError(
            "of the W8A8 routes only the fused one (lnq_fuse, attn_block, mlp_full) is ported")


def _attention_w8a8(x, lp, *, n_head: int, eps: float, causal: bool,
                    valid_len: int | None, kernels: bool):
    """``x + attn(ln1(x))`` over the raw residual stream ``x [B, S, H]``."""
    d_head = x.shape[-1] // n_head
    fn = attn_block if kernels else attn_block_plain
    return fn(x, lp["ln1_w"], lp["ln1_b"], lp["qkv_w"].c8, lp["qkv_w"].ws, lp["qkv_b"],
              lp["o_w"].c8, lp["o_w"].ws, lp["o_b"],
              n_head=lp["qkv_w"].shape[0] // 3 // d_head, scale=1.0 / d_head ** 0.5, eps=eps,
              causal=causal, valid_len=valid_len)


def _mlp_w8a8(x, lp, *, eps: float, use_gelu: bool, kernels: bool):
    b, s, h = x.shape
    fn = mlp_lnq if kernels else mlp_lnq_plain
    y = fn(x.reshape(b * s, h), lp["ln2_w"], lp["ln2_b"],
           lp["up_w"].c8, lp["up_w"].ws, lp["up_b"],
           lp["down_w"].c8, lp["down_w"].ws, lp["down_b"],
           eps=eps, act="gelu_tanh" if use_gelu else "gelu_quick")
    return y.reshape(b, s, h)


def _linear(x, w, bias, kernels: bool):
    """``x @ w.T`` in the dtype of ``x``, then ``+ bias`` in that dtype."""
    y = qmatmul(x, w, kernels=kernels)
    return y if bias is None else y + bias.to(y.dtype)


def _attention_dense(x, lp, *, n_head: int, eps: float, causal: bool,
                     valid_len: int | None, kernels: bool):
    b, s, h = x.shape
    d_head = h // n_head
    y = layernorm(x, lp["ln1_w"], lp["ln1_b"], eps)
    qkv = _linear(y.reshape(b * s, h), lp["qkv_w"], lp["qkv_b"], kernels)
    fn = mha_qkv if kernels else mha_qkv_plain
    out = fn(qkv.reshape(b, s, -1), n_head=qkv.shape[-1] // 3 // d_head,
             scale=1.0 / d_head ** 0.5, causal=causal, valid_len=valid_len)
    return x + _linear(out, lp["o_w"], lp["o_b"], kernels)


def _mlp_dense(x, lp, *, eps: float, use_gelu: bool, kernels: bool):
    y = layernorm(x, lp["ln2_w"], lp["ln2_b"], eps)
    y = _linear(y, lp["up_w"], lp["up_b"], kernels)
    y = gelu_tanh(y) if use_gelu else gelu_quick(y)
    y = _linear(y, lp["down_w"], None, kernels)
    return x + (y + lp["down_b"].to(y.dtype))


def block(x, lp, *, n_head: int, eps: float, use_gelu: bool, causal: bool = False,
          valid_len: int | None = None, lnq_fuse: bool = True, attn_block: bool = True,
          mlp_full: bool = True, kernels: bool = True):
    if route(lp) == "w8a8":
        _check_w8a8_flags(lnq_fuse, attn_block, mlp_full)
        attn, mlp = _attention_w8a8, _mlp_w8a8
    else:
        attn, mlp = _attention_dense, _mlp_dense
    x = attn(x, lp, n_head=n_head, eps=eps, causal=causal, valid_len=valid_len,
             kernels=kernels)
    return mlp(x, lp, eps=eps, use_gelu=use_gelu, kernels=kernels)


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
