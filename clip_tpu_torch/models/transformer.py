"""Shared CLIP transformer block over stacked layer parameters.

Numerics mirror the JAX package's ``models/transformer.py``: pre-LN ->
attention (Q pre-scaled by 1/sqrt(d_head)) -> residual -> pre-LN -> MLP
(quick-gelu or tanh-gelu) -> residual.  The route follows the layer weights'
type, as in the JAX package (:func:`route`):

* ``"w8a8"``: per-channel int8 layer weights (re-quantized from a
  block-quantized checkpoint) take the JAX package's W8A8 routes
  (``transformer.py:95-437``), chosen branch for branch by the same flags
  (``lnq_fuse``, ``attn_block``, ``mlp_full``, ``up_gq``, ``attn_i8``,
  ``mlp_stream``) and the same route gates, copied into ``ops.attention``
  and ``ops.actquant``, that the JAX package evaluates on a TPU for the
  same (B, S, widths):

  - attention: the whole block (``ops.attention.attn_block``) where the
    TPU's resident block fits; else the streamed block
    (``ops.attention.attn_block_stream``, its o input quantized per head
    group) where the TPU's streamed block fits; else LN + quant (``lnq``)
    and either the
    int8 route (``attn_i8``: ``gemm_gq`` with ``act="none"``, then
    ``mha_qkv_i8``) or ``w8a8_pre`` + ``qkv_b`` in the compute dtype, then
    attention with an int8 output feeding the o GEMM (``quant_o``) or a
    bf16 output feeding ``ops.linear.qmatmul``; with ``lnq_fuse`` off, LN in
    the compute dtype and ``qmatmul`` for both projections;
  - MLP: the whole block (``ops.actquant.mlp_lnq``) where the TPU's resident
    weights fit; else, with ``mlp_stream``, the weight-streamed block
    (``ops.actquant.mlp_lnq_stream``, ``exact=True``: the whole block's
    function) where the TPU's streamed block fits; else ``lnq`` ->
    ``gemm_gq`` -> the down GEMM with bias and residual; with ``up_gq`` (and
    ``lnq_fuse`` off) LN, the row quant, then ``mlp_gq`` or ``gemm_gq`` +
    ``w8a8_pre``; with neither, LN and ``qmatmul`` for both projections.
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

from ..ops import actquant as aq
from ..ops import attention as at
from ..ops.linear import qmatmul
from ..ops.nn import gelu_quick, gelu_tanh, layernorm, quant_rows
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


def _ops(kernels: bool):
    """The kernel wrappers, or their plain versions (``kernels=False``)."""
    if kernels:
        return dict(lnq=aq.lnq, gemm_gq=aq.gemm_gq, w8a8_pre=aq.w8a8_pre, mlp_gq=aq.mlp_gq,
                    mlp_lnq=aq.mlp_lnq, mlp_lnq_stream=aq.mlp_lnq_stream, gemm_i8=aq.gemm_i8,
                    attn_block=at.attn_block, attn_block_stream=at.attn_block_stream,
                    attention_heads=at.attention_heads, requant=aq.requant,
                    mha_qkv=at.mha_qkv, mha_qkv_i8=at.mha_qkv_i8)
    return dict(lnq=aq.lnq_plain, gemm_gq=aq.gemm_gq_plain, w8a8_pre=aq.w8a8_pre_plain,
                mlp_gq=aq.mlp_gq_plain, mlp_lnq=aq.mlp_lnq_plain,
                mlp_lnq_stream=aq.mlp_lnq_stream_plain, gemm_i8=aq.gemm_i8_plain,
                attn_block=at.attn_block_plain, attn_block_stream=at.attn_block_stream_plain,
                attention_heads=at.attention_heads_plain, requant=aq.requant_plain,
                mha_qkv=at.mha_qkv_plain, mha_qkv_i8=at.mha_qkv_i8_plain)


def _o_resid(k, codes, sx, x, lp):
    """``x + (w8a8_pre(codes, o_w) + o_b)`` as one int8 GEMM with the
    residual epilogue: ``bf16(x + bf16(bf16(acc*sx*ws) + bf16(b)))``, the
    JAX package's three steps in the compute dtype."""
    b, s, h = x.shape
    ow = lp["o_w"]
    out = k["gemm_i8"](codes, ow.c8, sx, ow.ws, lp["o_b"], aq.RESID, resid=x.reshape(b * s, h),
                       out_dtype=x.dtype)
    return out.reshape(b, s, h)


def _attention_w8a8(x, lp, *, n_head: int, eps: float, causal: bool,
                    valid_len: int | None, kernels: bool, lnq_fuse: bool,
                    attn_block: bool, attn_i8: bool):
    """``x + attn(ln1(x))`` over the raw residual stream ``x [B, S, H]``:
    the JAX package's ``attention(..., add_residual=True)`` on a TPU."""
    b, s, h = x.shape
    if not (lnq_fuse and aq.fusable_width(h)):
        # no LN + quant producer: LN in the compute dtype and both projections
        # through qmatmul, as on the dense route (the int8 attention output
        # needs the producer's conditions too, so it is off here)
        return _attention_dense(x, lp, n_head=n_head, eps=eps, causal=causal,
                                valid_len=valid_len, kernels=kernels)
    k = _ops(kernels)
    cdt = x.dtype
    d_head = h // n_head
    scale = 1.0 / d_head ** 0.5
    qkv_w, o_w = lp["qkv_w"], lp["o_w"]
    qkv_width = qkv_w.shape[0]
    h_loc = qkv_width // 3
    n_head_loc = h_loc // d_head
    o_w8 = isinstance(o_w, W8Tensor)
    flat = at.flat_eligible(b, s, qkv_width)
    quant_o = (o_w8 and aq.fusable_width(h_loc)
               and at.flat_eligible(b, s, qkv_width, quant_out=True))
    resident = (attn_block and o_w8 and flat
                and at.attn_block_fusable(h, qkv_width, o_w.shape[0], b, s))
    if (not resident and attn_block and o_w8 and flat and at.attn_block_stream_fusable(
            h, qkv_width, o_w.shape[0], b, s, n_head=n_head_loc)):
        return k["attn_block_stream"](x, lp["ln1_w"], lp["ln1_b"], qkv_w.c8, qkv_w.ws,
                                      lp["qkv_b"], o_w.c8, o_w.ws, lp["o_b"], n_head=n_head_loc,
                                      scale=scale, eps=eps, causal=causal, valid_len=valid_len,
                                      residual=True)
    if resident:
        return k["attn_block"](x, lp["ln1_w"], lp["ln1_b"], qkv_w.c8, qkv_w.ws, lp["qkv_b"],
                               o_w.c8, o_w.ws, lp["o_b"], n_head=n_head_loc, scale=scale,
                               eps=eps, causal=causal, valid_len=valid_len)
    codes, sx = k["lnq"](x.reshape(b * s, h), lp["ln1_w"], lp["ln1_b"], eps)
    if attn_i8 and flat:
        qc, qsx = k["gemm_gq"](codes, sx, qkv_w.c8, qkv_w.ws, lp["qkv_b"], "none")
        kw = dict(n_head=n_head_loc, scale=scale, causal=causal, valid_len=valid_len)
        if quant_o:
            oc, osx = k["mha_qkv_i8"](qc.reshape(b, s, -1), qsx.reshape(b, s),
                                      quant_out=True, **kw)
            return _o_resid(k, oc.reshape(b * s, h_loc), osx.reshape(b * s), x, lp)
        out = k["mha_qkv_i8"](qc.reshape(b, s, -1), qsx.reshape(b, s), out_dtype=cdt, **kw)
        proj = qmatmul(out, o_w, kernels=kernels)
        return x + (proj + lp["o_b"].to(proj.dtype))
    qkv = k["w8a8_pre"](codes, sx, qkv_w.c8, qkv_w.ws, cdt)
    qkv = qkv + lp["qkv_b"].to(cdt)
    if quant_o:
        att = k["attention_heads"](qkv, b, s, n_head_loc, scale, causal, valid_len)
        oc, osx = k["requant"](att)
        return _o_resid(k, oc, osx, x, lp)
    out = k["mha_qkv"](qkv.reshape(b, s, -1), n_head=n_head_loc, scale=scale, causal=causal,
                       valid_len=valid_len)
    return x + _linear(out, o_w, lp["o_b"], kernels)


def _mlp_w8a8(x, lp, *, eps: float, use_gelu: bool, kernels: bool, lnq_fuse: bool,
              mlp_full: bool, up_gq: bool, mlp_stream: bool):
    """``x + mlp(ln2(x))``: the JAX package's MLP half of ``block`` on a TPU."""
    k = _ops(kernels)
    b, s, h = x.shape
    cdt = x.dtype
    up_w, dn_w = lp["up_w"], lp["down_w"]
    n = up_w.shape[0]
    act = "gelu_tanh" if use_gelu else "gelu_quick"
    w8 = isinstance(up_w, W8Tensor) and isinstance(dn_w, W8Tensor)
    widths = aq.fusable_width(h) and aq.fusable_width(n)
    fuse_mlp = lnq_fuse and w8 and widths
    full = mlp_full and fuse_mlp and aq.mlp_fusable(h, n)
    x2 = x.reshape(b * s, h)
    if not full and mlp_full and mlp_stream and fuse_mlp and aq.mlp_stream_fusable(h, n):
        return k["mlp_lnq_stream"](x2, lp["ln2_w"], lp["ln2_b"], up_w.c8, up_w.ws, lp["up_b"],
                                   dn_w.c8, dn_w.ws, lp["down_b"], eps=eps, act=act,
                                   residual=True).reshape(b, s, h)
    if full:
        return k["mlp_lnq"](x2, lp["ln2_w"], lp["ln2_b"], up_w.c8, up_w.ws, lp["up_b"],
                            dn_w.c8, dn_w.ws, lp["down_b"], eps=eps, act=act).reshape(b, s, h)
    if fuse_mlp:
        codes, sx = k["lnq"](x2, lp["ln2_w"], lp["ln2_b"], eps)
        codes, sx = k["gemm_gq"](codes, sx, up_w.c8, up_w.ws, lp["up_b"], act)
        # w8a8_pre, + down_b, x + : the residual epilogue in one GEMM
        y = k["gemm_i8"](codes, dn_w.c8, sx, dn_w.ws, lp["down_b"], aq.RESID, resid=x2,
                         out_dtype=cdt)
        return y.reshape(b, s, h)
    if up_gq and w8 and widths:
        y = layernorm(x2, lp["ln2_w"], lp["ln2_b"], eps)
        codes, sx = quant_rows(y)
        if mlp_full and aq.mlp_fusable(h, n):
            y = k["mlp_gq"](codes, sx, up_w.c8, up_w.ws, lp["up_b"], dn_w.c8, dn_w.ws,
                            act=act, out_dtype=cdt)
        else:
            codes, sx = k["gemm_gq"](codes, sx, up_w.c8, up_w.ws, lp["up_b"], act)
            y = k["w8a8_pre"](codes, sx, dn_w.c8, dn_w.ws, cdt)
        return x + (y.reshape(b, s, h) + lp["down_b"].to(cdt))
    return _mlp_dense(x, lp, eps=eps, use_gelu=use_gelu, kernels=kernels)


def _linear(x, w, bias, kernels: bool):
    """``x @ w.T`` in the dtype of ``x``, then ``+ bias`` in that dtype."""
    y = qmatmul(x, w, kernels=kernels)
    return y if bias is None else y + bias.to(y.dtype)


def _attention_dense(x, lp, *, n_head: int, eps: float, causal: bool,
                     valid_len: int | None, kernels: bool, **_flags):
    b, s, h = x.shape
    d_head = h // n_head
    y = layernorm(x, lp["ln1_w"], lp["ln1_b"], eps)
    qkv = _linear(y.reshape(b * s, h), lp["qkv_w"], lp["qkv_b"], kernels)
    fn = at.mha_qkv if kernels else at.mha_qkv_plain
    out = fn(qkv.reshape(b, s, -1), n_head=qkv.shape[-1] // 3 // d_head,
             scale=1.0 / d_head ** 0.5, causal=causal, valid_len=valid_len)
    return x + _linear(out, lp["o_w"], lp["o_b"], kernels)


def _mlp_dense(x, lp, *, eps: float, use_gelu: bool, kernels: bool, **_flags):
    y = layernorm(x, lp["ln2_w"], lp["ln2_b"], eps)
    y = _linear(y, lp["up_w"], lp["up_b"], kernels)
    y = gelu_tanh(y) if use_gelu else gelu_quick(y)
    y = _linear(y, lp["down_w"], None, kernels)
    return x + (y + lp["down_b"].to(y.dtype))


def block(x, lp, *, n_head: int, eps: float, use_gelu: bool, causal: bool = False,
          valid_len: int | None = None, lnq_fuse: bool = True, attn_block: bool = True,
          mlp_full: bool = True, up_gq: bool = False, attn_i8: bool = False,
          mlp_stream: bool = False, kernels: bool = True):
    """One layer over ``x [B, S, H]``; the flags choose among the W8A8
    routes as in the JAX package's ``block`` (the dense route ignores them)."""
    attn, mlp = ((_attention_w8a8, _mlp_w8a8) if route(lp) == "w8a8"
                 else (_attention_dense, _mlp_dense))
    x = attn(x, lp, n_head=n_head, eps=eps, causal=causal, valid_len=valid_len,
             kernels=kernels, lnq_fuse=lnq_fuse, attn_block=attn_block, attn_i8=attn_i8)
    return mlp(x, lp, eps=eps, use_gelu=use_gelu, kernels=kernels, lnq_fuse=lnq_fuse,
               mlp_full=mlp_full, up_gq=up_gq, mlp_stream=mlp_stream)


def layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked ``[L, ...]`` parameters (views, no copy)."""
    return {k: v[i] for k, v in layers.items()}


def run_blocks(x, layers: dict, *, n_head: int, eps: float, use_gelu: bool,
               causal: bool = False, valid_len: int | None = None, kernels: bool = True,
               **flags):
    """Run the transformer stack; ``layers`` leaves carry a leading L axis.
    A Python loop takes the place of the JAX package's ``lax.scan``;
    ``flags`` (``lnq_fuse``, ``attn_block``, ``mlp_full``, ``up_gq``,
    ``attn_i8``, ``mlp_stream``) pass to every :func:`block`."""
    for i in range(layers["ln1_w"].shape[0]):
        x = block(x, layer(layers, i), n_head=n_head, eps=eps, use_gelu=use_gelu,
                  causal=causal, valid_len=valid_len, kernels=kernels, **flags)
    return x
