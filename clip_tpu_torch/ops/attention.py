"""The whole attention block (counterpart of the JAX package's
``ops/attention_pallas.py:484 attn_block_pallas``) and multi-head attention
over a fused qkv projection (counterpart of ``ops/attention_pallas.py:1014
mha_pallas_qkv``).

``x [B, S, H]`` -> ``x + o_proj(attention(qkv_proj(ln(x))))`` with int8
projections: LN -> row int8 quant -> int8 qkv GEMM -> ``acc*s1*ws + b`` in
f32, rounded to the compute dtype -> per-head ``softmax(clip(q.scale.k^T,
+-80) + mask) . v`` -> row requant with the full-row amax -> int8 o GEMM ->
``acc*s2*ws``, + o bias, + residual.

On a card the block is a chain of hand-written kernels (``csrc/actquant.cu``
and ``csrc/attention.cu``); on the CPU the plain version runs.  No padding is
needed by the kernels: attention runs per image at the given S, and the
GEMMs mask their ragged row tiles.

:func:`mha_qkv` is the same attention core with its per-head output rounded
to the compute dtype, as ``mha_pallas_qkv`` writes it; the TPU kernel's
``quant_out=True`` form is :func:`attention_heads` followed by
``ops.actquant.requant``.  The core takes any S up to 640 at d_head 64 or 80
(:func:`attention_smem`); the wrappers raise before a launch it cannot take.
"""

from __future__ import annotations

import torch

from . import _cuda
from .actquant import (BIAS, RESID, gemm_i8, gemm_i8_plain, lnq, lnq_plain,
                       requant, requant_plain)

__all__ = ["NEG_INF", "attention_heads", "attention_heads_plain", "attn_block",
           "attn_block_plain", "mha_qkv", "mha_qkv_plain"]

NEG_INF = -1e9
_SM_BOUND = 80.0


def _mask(s: int, causal: bool, valid_len: int, device) -> torch.Tensor:
    """Additive [S, S] mask: -1e9 on keys >= valid_len and, if causal, on
    keys after the query."""
    cols = torch.arange(s, device=device)
    invalid = (cols >= valid_len)[None, :].expand(s, s)
    if causal:
        invalid = invalid | (cols[None, :] > cols[:, None])
    return torch.where(invalid, NEG_INF, 0.0).to(torch.float32)


def attention_heads_plain(qkv, b: int, s: int, n_head: int, scale: float,
                          causal: bool = False, valid_len: int | None = None):
    """Per-head attention over a fused ``qkv [B*S, 3*Hl]`` in the compute
    dtype -> float32 ``[B*S, Hl]`` (heads side by side)."""
    cdt = qkv.dtype
    hl = qkv.shape[1] // 3
    dh = hl // n_head
    q, k, v = qkv.reshape(b, s, 3, n_head, dh).permute(2, 0, 3, 1, 4)
    q = q * torch.tensor(scale, dtype=cdt)  # scale rounded to the compute dtype
    scores = q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)
    bias = _mask(s, causal, s if valid_len is None else valid_len, qkv.device)
    p = torch.exp(torch.clamp(scores, -_SM_BOUND, _SM_BOUND) + bias)
    p = p / p.sum(dim=-1, keepdim=True)
    out = p.to(cdt).to(torch.float32) @ v.to(torch.float32)
    return out.permute(0, 2, 1, 3).reshape(b * s, hl)


_ATTN_WARPS = 4
SMEM_LIMIT = 232_448  # bytes of shared memory a block may have on Hopper


def attention_smem(s: int, dh: int) -> int:
    """Bytes of shared memory ``ctt_attention`` takes at sequence length
    ``s`` and head width ``dh``: K and V rows of ``dh + 2`` bf16, and one f32
    p row and one f32 query row per warp (``csrc/attention.cu``)."""
    return 2 * s * (dh + 2) * 2 + _ATTN_WARPS * (s + dh) * 4


def _attention(qkv, b: int, s: int, n_head: int, scale: float, causal: bool,
               valid_len: int | None, out_dtype: torch.dtype, name: str):
    """Launch ``ctt_attention`` over ``qkv [B*S, 3*Hl]`` bf16 -> ``[B*S, Hl]``
    in ``out_dtype`` (float32 or bfloat16)."""
    h3 = qkv.shape[-1]
    hl = h3 // 3
    dh = hl // n_head
    _cuda.require(qkv, "qkv", torch.bfloat16, (b * s, h3), qkv.device)
    if h3 % 3 or hl % n_head or dh % 2:
        raise ValueError(f"{name}: width {h3} does not split into 3 x {n_head} even heads")
    vl = s if valid_len is None else valid_len
    if not 1 <= vl <= s:
        raise ValueError(f"{name}: valid_len {vl} outside [1, {s}]")
    if attention_smem(s, dh) > SMEM_LIMIT:
        raise ValueError(f"{name}: S = {s}, d_head = {dh} needs {attention_smem(s, dh)} B of "
                         f"shared memory, more than the {SMEM_LIMIT} B a block may have")
    out = torch.empty(b * s, hl, dtype=out_dtype, device=qkv.device)
    _cuda.check(_cuda.lib().ctt_attention(
        qkv.data_ptr(), out.data_ptr(), b, s, n_head, dh, float(scale), int(causal), vl,
        int(out_dtype == torch.bfloat16), _cuda.stream(qkv)), name)
    return out


def attention_heads(qkv, b: int, s: int, n_head: int, scale: float,
                    causal: bool = False, valid_len: int | None = None):
    """:func:`attention_heads_plain` on the card (``ctt_attention``, f32 out)."""
    if qkv.device.type == "cpu":
        return attention_heads_plain(qkv, b, s, n_head, scale, causal, valid_len)
    out = _attention(qkv, b, s, n_head, scale, causal, valid_len, torch.float32,
                     "attention_heads")
    attention_heads.launches += 1
    return out


def mha_qkv_plain(qkv, *, n_head: int, scale: float, causal: bool = False,
                  valid_len: int | None = None):
    """Multi-head attention over the fused projection ``qkv [B, S, 3H]`` ->
    ``[B, S, H]`` in the dtype of ``qkv``: :func:`attention_heads_plain`
    with each head's f32 output rounded to that dtype."""
    b, s, h3 = qkv.shape
    out = attention_heads_plain(qkv.reshape(b * s, h3), b, s, n_head, scale, causal, valid_len)
    return out.to(qkv.dtype).reshape(b, s, h3 // 3)


def mha_qkv(qkv, *, n_head: int, scale: float, causal: bool = False,
            valid_len: int | None = None):
    """Counterpart of ``mha_pallas_qkv`` (both its bodies):
    :func:`mha_qkv_plain` on the card (``ctt_attention``, bf16 out).  Keys
    ``>= valid_len`` are masked in every image."""
    if qkv.device.type == "cpu":
        return mha_qkv_plain(qkv, n_head=n_head, scale=scale, causal=causal,
                             valid_len=valid_len)
    b, s, h3 = qkv.shape
    out = _attention(qkv.reshape(b * s, h3), b, s, n_head, scale, causal, valid_len,
                     torch.bfloat16, "mha_qkv")
    mha_qkv.launches += 1
    return out.reshape(b, s, h3 // 3)


def attn_block_plain(x, lnw, lnb, qw8, qws, qb, ow8, ows, ob, *, n_head: int,
                     scale: float, eps: float, causal: bool = False,
                     valid_len: int | None = None):
    b, s, h = x.shape
    x2 = x.reshape(b * s, h)
    c1, s1 = lnq_plain(x2, lnw, lnb, eps)
    qkv = gemm_i8_plain(c1, qw8, s1, qws, qb, BIAS, out_dtype=x.dtype)
    att = attention_heads_plain(qkv, b, s, n_head, scale, causal, valid_len)
    c2, s2 = requant_plain(att)
    out = gemm_i8_plain(c2, ow8, s2, ows, ob, RESID, resid=x2, out_dtype=x.dtype)
    return out.reshape(b, s, -1)


def attn_block(x, lnw, lnb, qw8, qws, qb, ow8, ows, ob, *, n_head: int,
               scale: float, eps: float, causal: bool = False,
               valid_len: int | None = None):
    """Whole attention block with o bias and residual over ``x [B, S, H]``.

    ``qw8 [3Hl, H]``/``qws``/``qb`` and ``ow8 [H, Hl]``/``ows``/``ob`` are the
    int8 per-channel projection weights with their f32 scales and biases."""
    if x.device.type == "cpu":
        return attn_block_plain(x, lnw, lnb, qw8, qws, qb, ow8, ows, ob, n_head=n_head,
                                scale=scale, eps=eps, causal=causal, valid_len=valid_len)
    b, s, h = x.shape
    h3 = qw8.shape[0]
    _cuda.require(qw8, "qw8", torch.int8, (h3, h), x.device)
    _cuda.require(ow8, "ow8", torch.int8, (h, h3 // 3), x.device)
    x2 = x.reshape(b * s, h)
    c1, s1 = lnq(x2, lnw, lnb, eps)
    qkv = gemm_i8(c1, qw8, s1, qws, qb, BIAS)
    att = attention_heads(qkv, b, s, n_head, scale, causal, valid_len)
    c2, s2 = requant(att)
    out = gemm_i8(c2, ow8, s2, ows, ob, RESID, resid=x2)
    attn_block.launches += 1
    return out.reshape(b, s, h)


for _fn in (attention_heads, attn_block, mha_qkv):
    _fn.launches = 0
