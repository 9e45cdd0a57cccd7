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
``ops.actquant.requant``.  On bf16 (and int8) inputs the core runs on the
tensor cores in query tiles of 64 rows with K and V streamed through shared
memory, so it takes any S at a d_head that is a multiple of 16 up to 128
(:func:`attention_plan`); the f32 form of :func:`mha` keeps a CUDA-core
kernel that holds a head's K and V in shared memory (S <= 344 at d_head 80,
425 at 64).  The wrappers raise before a launch the kernels cannot take.

:func:`mha_qkv_i8` (counterpart of ``ops/attention_pallas.py:278
mha_pallas_qkv_i8``) is attention over an int8 qkv projection with per-row
scales: the q.k dot exact in integers, V dequantized to bf16 per row.

The rest of the JAX package's attention kernels:

* :func:`attn_block_stream` (``attention_pallas.py:648
  attn_block_stream_pallas``): row 1's chain with the o GEMM's input
  quantized per head group of ``hg`` heads (``ops.actquant.requant`` with
  ``group``) and the o GEMM summed over the groups in f32 (the ``GROUPED``
  epilogue of ``ctt_gemm_i8``);
* :func:`mha` (``attention_pallas.py:1119 mha_pallas``): attention over
  separate q, k, v in bf16 or f32, output in their dtype
  (``ctt_attention`` with three base pointers);
* :func:`layer_block` (``attention_pallas.py:877 layer_block_pallas``): one
  whole layer, :func:`attn_block` then ``ops.actquant.mlp_lnq``.  No kernel
  of its own: an SM's 227 KB cannot hold one layer's int8 weights, and the
  JAX package found its one-call layer slower than the two blocks and
  bit-equal to them on the chip.

The module also keeps copies of the JAX package's attention route gates
(:func:`flat_eligible`, :func:`attn_block_fusable`,
:func:`attn_block_stream_fusable`, :func:`layer_block_fusable`) and the
streamed block's plan (:func:`_ablk_stream_plan`).  They are TPU VMEM
budgets, copied only so that the port takes the reference's route for a
geometry, and the head group ``hg`` the reference quantizes by, which fix
the function computed; no CUDA launch decision depends on them.
"""

from __future__ import annotations

import torch

from . import _cuda
from .actquant import (BIAS, GROUPED, RESID, gemm_i8, gemm_i8_plain, lnq, lnq_plain, mlp_lnq,
                       mlp_lnq_plain, requant, requant_plain)

__all__ = ["NEG_INF", "attention_heads", "attention_heads_plain", "attention_plan", "attn_block",
           "attn_block_fusable", "attn_block_plain", "attn_block_stream",
           "attn_block_stream_fusable", "attn_block_stream_plain", "flat_eligible",
           "layer_block", "layer_block_fusable", "layer_block_plain", "mha", "mha_plain",
           "mha_qkv", "mha_qkv_i8", "mha_qkv_i8_plain", "mha_qkv_plain"]

NEG_INF = -1e9
_SM_BOUND = 80.0


# -- route gates, copied from the JAX package's ops/attention_pallas.py -------

_FLAT_MAX_ROWS = 448
_FLAT_MIN_ROWS = 128
_FLAT_MAX_S1 = 640
_FLAT_VMEM_BUDGET = 12 * 2**20


def _flat_block_b(b: int, s: int, h3: int | None = None,
                  quant_out: bool = False) -> "int | None":
    """``attention_pallas.py:958``: images per grid step of the TPU's flat
    attention kernel, or None where that kernel cannot take the shape."""
    g = 2 if s % 2 == 0 else 1
    g = 4 if s % 4 == 0 else g
    g = 8 if s % 8 == 0 else g
    base = 8 // g
    bb = base * max(1, -(-_FLAT_MIN_ROWS // (base * s)))
    if bb * s > _FLAT_MAX_ROWS:
        if base == 1 and s <= _FLAT_MAX_S1 and h3 is not None:
            h = h3 // 3
            vmem = s * h3 * 2 + s * h * 2 + 2 * s * s * 4
            if quant_out:
                vmem += 2 * s * h * 4 + s * h
            if vmem > _FLAT_VMEM_BUDGET:
                return None
            bb = 1
        else:
            return None
    return min(bb, b) if (min(bb, b) * s) % 8 == 0 else None


def flat_eligible(b: int, s: int, h3: int | None = None, quant_out: bool = False) -> bool:
    """``attention_pallas.py:1000``."""
    return _flat_block_b(b, s, h3, quant_out) is not None


_ABLK_BUDGET = 19 * 1024 * 1024


def _ablk_resid(rt: int, h: int, qkv_width: int, o_out: int) -> int:
    """``attention_pallas.py:377``."""
    h_loc = qkv_width // 3
    weights = qkv_width * h + o_out * h_loc
    return weights + rt * (7 * h + 6 * qkv_width + 5 * h_loc + 6 * o_out) + 8 * rt * rt


def attn_block_fusable(h: int, qkv_width: int, o_out: int, b: int = 8, s: int = 8) -> bool:
    """``attention_pallas.py:383``: the resident attention block (row 1)."""
    h_loc = qkv_width // 3
    if h % 128 != 0 or h_loc % 128 != 0:
        return False
    bb = _flat_block_b(b, s, qkv_width)
    if bb is None:
        return False
    return _ablk_resid(bb * s, h, qkv_width, o_out) <= _ABLK_BUDGET


def _ablk_stream_plan(rt: int, h: int, qkv_width: int, o_out: int,
                      dh: int) -> "tuple[int, int] | None":
    """``attention_pallas.py:597``."""
    hl = qkv_width // 3
    n_head = hl // dh
    for cq in (3, 4, 6, 8, 2):
        if qkv_width % cq or (qkv_width // cq) % 128:
            continue
        ncq = qkv_width // cq
        for hg in (4, 2, 8, 16, 1):
            if n_head % hg or (hg * dh) % 128:
                continue
            resident = (rt * h * 2 * 2 + rt * h + rt * qkv_width * 2 + rt * o_out * 4
                        + 2 * rt * rt * 4 + 2 * ncq * h + 2 * o_out * hg * dh
                        + 2 * rt * o_out * 2)
            if resident <= 14 * 1024 * 1024:
                return cq, hg
    return None


def attn_block_stream_fusable(h: int, qkv_width: int, o_out: int, b: int = 8, s: int = 8,
                              n_head: int | None = None) -> bool:
    """``attention_pallas.py:631``: the streamed attention block (row 8)."""
    h_loc = qkv_width // 3
    if h % 128 != 0 or h_loc % 128 != 0:
        return False
    if n_head is None:
        return False
    bb = _flat_block_b(b, s, qkv_width)
    if bb is None:
        return False
    return _ablk_stream_plan(bb * s, h, qkv_width, o_out, h_loc // n_head) is not None


_LAYER_BUDGET = 26 * 1024 * 1024


def _layer_resid(rt: int, h: int, qkv_width: int, o_out: int, n4h: int) -> int:
    """``attention_pallas.py:839``."""
    return _ablk_resid(rt, h, qkv_width, o_out) + 2 * n4h * h + rt * 10 * n4h


def layer_block_fusable(h: int, qkv_width: int, o_out: int, n4h: int, b: int = 8,
                        s: int = 8) -> bool:
    """``attention_pallas.py:845``: the whole-layer kernel (row 12) takes
    this geometry."""
    if not attn_block_fusable(h, qkv_width, o_out, b, s):
        return False
    if o_out != h or qkv_width != 3 * h:
        return False
    bb = _flat_block_b(b, s, qkv_width)
    return _layer_resid(bb * s, h, qkv_width, o_out, n4h) <= _LAYER_BUDGET


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


SMEM_LIMIT = 232_448  # bytes of shared memory a block may have on Hopper
_BQ = _BK = 64        # query rows a block, keys a shared-memory tile (csrc/attention.cu)
_THREADS = 128        # four warps of 16 query rows
_MAX_DH = 128         # the Q and O fragments of a d_head live in registers
_ROWSUM_SMEM = 4 * 16 * (_BK + 4) * 4  # each warp's 16 rows of e, for the row sums


def attention_smem(s: int, dh: int, itemsize: int = 2) -> int:
    """Bytes of shared memory ``ctt_attention`` takes at sequence length
    ``s`` and head width ``dh`` (``csrc/attention.cu``).  bf16 in
    (``itemsize`` 2): two buffers of a 64-key K tile and a V tile, rows of
    ``dh + 8`` elements, and the row-sum scratch, whatever ``s``.  f32 in
    (4): the CUDA-core kernel's whole K and V of a head in rows of
    ``dh + 2``, and one f32 p row and one query row per warp."""
    if itemsize == 2:
        return 2 * 2 * _BK * (dh + 8) * 2 + _ROWSUM_SMEM
    return (2 * s * (dh + 2) + 4 * (s + dh)) * 4


def _i8_pad(dh: int) -> int:
    return -(-dh // 32) * 32


def attention_i8_smem(s: int, dh: int) -> int:
    """Bytes of shared memory ``ctt_attention_i8`` takes, whatever ``s``: the
    dequantized bf16 V tile (rows of ``dh + 8``), two buffers of 64 K rows
    of codes (``dh`` padded to a multiple of 32, + 16 bytes), two of V codes,
    two of the K rows' scales and the row-sum scratch (``csrc/attention.cu``)."""
    return (_BK * (dh + 8) * 2 + 2 * _BK * (_i8_pad(dh) + 16) + 2 * _BK * dh + 2 * _BK * 4
            + _ROWSUM_SMEM)


def attention_plan(b: int, s: int, n_head: int, dh: int, kind: str = "bf16") -> dict:
    """The launch of an attention kernel: ``grid``, ``threads``, shared
    ``smem`` bytes and the d_head the block computes with (``dh_pad``).
    ``kind``: ``"bf16"`` or ``"i8"`` (the tensor-core kernels, one block per
    64 query rows of a head of an image) or ``"f32"`` (one block per head of
    an image).  Raises ValueError on a geometry the kernel cannot take."""
    if kind == "f32":
        if dh % 2:
            raise ValueError(f"d_head {dh} must be even")
        grid = (n_head, b)
        smem = attention_smem(s, dh, 4)
        if smem > SMEM_LIMIT:
            raise ValueError(f"S = {s}, d_head = {dh} needs {smem} B of shared memory, more "
                             f"than the {SMEM_LIMIT} B a block may have")
        plan = dict(grid=grid, threads=_THREADS, smem=smem, dh_pad=dh)
    elif kind in ("bf16", "i8"):
        if dh % 16 or not 16 <= dh <= _MAX_DH:
            raise ValueError(f"d_head {dh} must be a multiple of 16 up to {_MAX_DH}")
        grid = (-(-s // _BQ), n_head, b)
        smem = attention_smem(s, dh) if kind == "bf16" else attention_i8_smem(s, dh)
        plan = dict(grid=grid, threads=_THREADS, smem=smem,
                    dh_pad=dh if kind == "bf16" else _i8_pad(dh))
    else:
        raise ValueError(f"kind {kind!r}: expected 'bf16', 'i8' or 'f32'")
    return plan


def _plan(name: str, b: int, s: int, n_head: int, dh: int, kind: str) -> dict:
    """:func:`attention_plan`, its error named after the wrapper ``name``."""
    try:
        return attention_plan(b, s, n_head, dh, kind)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def _aligned(name: str, **ptrs: int) -> None:
    """The tensor-core kernels copy 16-byte chunks: raise unless every
    pointer is 16-byte aligned."""
    for k, v in ptrs.items():
        if v % 16:
            raise ValueError(f"{name}: {k} at {v:#x} is not 16-byte aligned")


# ctt_attention's io codes: (input dtype, output dtype)
_ATTN_IO = {(torch.bfloat16, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
            (torch.float32, torch.float32): 2}


def _attention(q, k_ptr: int, v_ptr: int, ld: int, b: int, s: int, n_head: int, dh: int,
               scale: float, causal: bool, valid_len: int | None, out_dtype: torch.dtype,
               name: str):
    """Launch ``ctt_attention`` over rows of ``ld`` elements starting at
    ``q``'s data and the K and V pointers (of ``q``'s dtype, on its device)
    -> ``[B*S, n_head*dh]`` in ``out_dtype``."""
    io = _ATTN_IO.get((q.dtype, out_dtype))
    if io is None:
        raise TypeError(f"{name}: {q.dtype} in, {out_dtype} out is not a form of the kernel")
    vl = s if valid_len is None else valid_len
    if not 1 <= vl <= s:
        raise ValueError(f"{name}: valid_len {vl} outside [1, {s}]")
    _plan(name, b, s, n_head, dh, "f32" if io == 2 else "bf16")
    if io == 2:
        if ld % 2:
            raise ValueError(f"{name}: row stride {ld} must be even")
    else:
        if ld % 8:
            raise ValueError(f"{name}: row stride {ld} must be a multiple of 8")
        _aligned(name, q=q.data_ptr(), k=k_ptr, v=v_ptr)
    out = torch.empty(b * s, n_head * dh, dtype=out_dtype, device=q.device)
    _cuda.check(_cuda.lib().ctt_attention(
        q.data_ptr(), k_ptr, v_ptr, ld, out.data_ptr(), b, s, n_head, dh, float(scale), int(causal), vl, io,
        _cuda.stream(q)), name)
    return out


def _attention_qkv(qkv, b: int, s: int, n_head: int, scale: float, causal: bool,
                   valid_len: int | None, out_dtype: torch.dtype, name: str):
    """``ctt_attention`` over the packed ``qkv [B*S, 3*Hl]`` bf16 -> ``[B*S,
    Hl]`` in ``out_dtype`` (float32 or bfloat16)."""
    h3 = qkv.shape[-1]
    hl = h3 // 3
    _cuda.require(qkv, "qkv", torch.bfloat16, (b * s, h3), qkv.device)
    if h3 % 3 or hl % n_head:
        raise ValueError(f"{name}: width {h3} does not split into 3 x {n_head} heads")
    base, step = qkv.data_ptr(), hl * qkv.element_size()
    return _attention(qkv, base + step, base + 2 * step, h3, b, s, n_head, hl // n_head, scale,
                      causal, valid_len, out_dtype, name)


def attention_heads(qkv, b: int, s: int, n_head: int, scale: float,
                    causal: bool = False, valid_len: int | None = None):
    """:func:`attention_heads_plain` on the card (``ctt_attention``, f32 out)."""
    if qkv.device.type == "cpu":
        return attention_heads_plain(qkv, b, s, n_head, scale, causal, valid_len)
    out = _attention_qkv(qkv, b, s, n_head, scale, causal, valid_len, torch.float32,
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
    out = _attention_qkv(qkv.reshape(b * s, h3), b, s, n_head, scale, causal, valid_len,
                         torch.bfloat16, "mha_qkv")
    mha_qkv.launches += 1
    return out.reshape(b, s, h3 // 3)


def attention_i8_plain(codes, sx, b: int, s: int, n_head: int, scale: float,
                       causal: bool = False, valid_len: int | None = None):
    """Per-head attention over an int8 qkv projection ``codes [B*S, 3*Hl]``
    with per-row scales ``sx [B*S]`` -> float32 ``[B*S, Hl]``, in the order of
    the TPU kernel (``attention_pallas.py:215 _qkv_kernel_flat_i8``): the
    integer q.k dot exactly (float64 holds it), ``acc * (sx_q * scale) *
    sx_k`` in float32, the clipped softmax with the -1e9 mask, p rounded to
    bf16, V as ``bf16(code * sx)`` of its own row, p.V in float32."""
    hl = codes.shape[1] // 3
    dh = hl // n_head
    q, k, v = codes.reshape(b, s, 3, n_head, dh).permute(2, 0, 3, 1, 4)
    sxb = sx.reshape(b, s).to(torch.float32)
    acc = q.to(torch.float64) @ k.to(torch.float64).transpose(-1, -2)
    srow = sxb * torch.tensor(scale, dtype=torch.float32)
    scores = acc.to(torch.float32) * srow[:, None, :, None] * sxb[:, None, None, :]
    bias = _mask(s, causal, s if valid_len is None else valid_len, codes.device)
    p = torch.exp(torch.clamp(scores, -_SM_BOUND, _SM_BOUND) + bias)
    p = p / p.sum(dim=-1, keepdim=True)
    vh = (v.to(torch.float32) * sxb[:, None, :, None]).to(torch.bfloat16)
    out = p.to(torch.bfloat16).to(torch.float32) @ vh.to(torch.float32)
    return out.permute(0, 2, 1, 3).reshape(b * s, hl)


def mha_qkv_i8_plain(codes, scales, *, n_head: int, scale: float, causal: bool = False,
                     valid_len: int | None = None, quant_out: bool = False,
                     out_dtype=torch.bfloat16):
    """Multi-head attention over int8 qkv codes ``[B, S, 3H]`` with row scales
    ``[B, S]`` -> ``[B, S, H]`` in ``out_dtype``, or with ``quant_out`` the
    output's row int8 requant over all heads: (codes ``[B, S, H]``, scales
    ``[B, S]``)."""
    b, s, h3 = codes.shape
    out = attention_i8_plain(codes.reshape(b * s, h3), scales.reshape(b * s), b, s, n_head,
                             scale, causal, valid_len)
    if quant_out:
        c, sc = requant_plain(out)
        return c.reshape(b, s, h3 // 3), sc.reshape(b, s)
    return out.to(out_dtype).reshape(b, s, h3 // 3)


def mha_qkv_i8(codes, scales, *, n_head: int, scale: float, causal: bool = False,
               valid_len: int | None = None, quant_out: bool = False,
               out_dtype=torch.bfloat16):
    """Counterpart of ``mha_pallas_qkv_i8``: :func:`mha_qkv_i8_plain` on the
    card (``ctt_attention_i8``, bf16 out; with ``quant_out`` f32 out, then
    ``ctt_requant`` over the full row, as the TPU kernel's ``_quant_heads``
    takes the max over heads)."""
    if codes.device.type == "cpu":
        return mha_qkv_i8_plain(codes, scales, n_head=n_head, scale=scale, causal=causal,
                                valid_len=valid_len, quant_out=quant_out, out_dtype=out_dtype)
    b, s, h3 = codes.shape
    hl = h3 // 3
    dh = hl // n_head
    _cuda.require(codes, "codes", torch.int8, (b, s, h3), codes.device)
    _cuda.require(scales, "scales", torch.float32, (b, s), codes.device)
    if h3 % 3 or hl % n_head:
        raise ValueError(f"mha_qkv_i8: width {h3} does not split into 3 x {n_head} heads")
    if not quant_out and out_dtype != torch.bfloat16:
        raise TypeError(f"mha_qkv_i8: the kernel writes bfloat16, not {out_dtype}")
    vl = s if valid_len is None else valid_len
    if not 1 <= vl <= s:
        raise ValueError(f"mha_qkv_i8: valid_len {vl} outside [1, {s}]")
    _plan("mha_qkv_i8", b, s, n_head, dh, "i8")
    _aligned("mha_qkv_i8", codes=codes.data_ptr())
    odt = torch.float32 if quant_out else torch.bfloat16
    out = torch.empty(b * s, hl, dtype=odt, device=codes.device)
    _cuda.check(_cuda.lib().ctt_attention_i8(
        codes.data_ptr(), scales.data_ptr(), out.data_ptr(), b, s, n_head, dh, float(scale),
        int(causal), vl, int(odt == torch.bfloat16), _cuda.stream(codes)), "mha_qkv_i8")
    mha_qkv_i8.launches += 1
    if quant_out:
        c, sc = requant(out)
        return c.reshape(b, s, hl), sc.reshape(b, s)
    return out.reshape(b, s, hl)


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


def stream_heads(b: int, s: int, h: int, h3: int, h_out: int, n_head: int,
                 hg: int | None = None) -> int:
    """Heads per group whose attention output the streamed block quantizes
    together: ``hg`` or the copied plan's (``_ablk_stream_plan`` at the flat
    kernel's row block, as ``attn_block_stream_pallas`` takes it)."""
    bb = _flat_block_b(b, s, h3)
    if bb is None:
        raise ValueError("attn_block_stream requires the flat path: gate on flat_eligible")
    dh = h3 // 3 // n_head
    plan = _ablk_stream_plan(bb * s, h, h3, h_out, dh)
    if plan is None:
        raise ValueError(f"no stream plan for rt={bb * s} h={h} h3={h3}")
    hg = hg or plan[1]
    if n_head % hg or (hg * dh) % 128:
        raise ValueError(f"bad head group hg={hg}")
    return hg


def attn_block_stream_plain(x, lnw, lnb, qw8, qws, qb, ow8, ows, ob=None, *, n_head: int,
                            scale: float, eps: float, causal: bool = False,
                            valid_len: int | None = None, residual: bool = False,
                            hg: int | None = None):
    """Row 1's chain over ``x [B, S, H]`` with the attention output
    requantized per head group (``hg * d_head`` columns) and the o GEMM
    summed over the groups in f32; then ``bf16(acc)``, ``+ ob`` and, with
    ``residual``, ``x +`` in the dtype of ``x``.  Without ``ob`` the output
    is pre-bias."""
    b, s, h = x.shape
    h3, h_out = qw8.shape[0], ow8.shape[0]
    if residual and (ob is None or h_out != h):
        raise ValueError("residual=True requires ob and H_out == H")
    g = stream_heads(b, s, h, h3, h_out, n_head, hg) * (h3 // 3 // n_head)
    x2 = x.reshape(b * s, h)
    c1, s1 = lnq_plain(x2, lnw, lnb, eps)
    qkv = gemm_i8_plain(c1, qw8, s1, qws, qb, BIAS, out_dtype=x.dtype)
    att = attention_heads_plain(qkv, b, s, n_head, scale, causal, valid_len)
    c2, s2 = requant_plain(att, group=g)
    out = gemm_i8_plain(c2, ow8, s2, ows, ob, GROUPED, resid=x2 if residual else None,
                        out_dtype=x.dtype, group=g)
    return out.reshape(b, s, h_out)


def attn_block_stream(x, lnw, lnb, qw8, qws, qb, ow8, ows, ob=None, *, n_head: int,
                      scale: float, eps: float, causal: bool = False,
                      valid_len: int | None = None, residual: bool = False,
                      hg: int | None = None):
    """Counterpart of ``attn_block_stream_pallas``: :func:`attn_block_stream_plain`
    on the card.  ``ctt_lnq`` -> qkv ``ctt_gemm_i8`` (bias, bf16) ->
    ``ctt_attention`` (f32) -> ``ctt_requant`` per head group -> o
    ``ctt_gemm_i8`` with the grouped epilogue.

    The TPU kernel streams the qkv weight in ``cq`` column chunks and the o
    weight in head-group chunks through VMEM, which does not change a value;
    its head-group quantization does, and is kept."""
    if x.device.type == "cpu":
        return attn_block_stream_plain(x, lnw, lnb, qw8, qws, qb, ow8, ows, ob, n_head=n_head,
                                       scale=scale, eps=eps, causal=causal,
                                       valid_len=valid_len, residual=residual, hg=hg)
    b, s, h = x.shape
    h3, h_out = qw8.shape[0], ow8.shape[0]
    if residual and (ob is None or h_out != h):
        raise ValueError("residual=True requires ob and H_out == H")
    _cuda.require(qw8, "qw8", torch.int8, (h3, h), x.device)
    _cuda.require(ow8, "ow8", torch.int8, (h_out, h3 // 3), x.device)
    g = stream_heads(b, s, h, h3, h_out, n_head, hg) * (h3 // 3 // n_head)
    x2 = x.reshape(b * s, h)
    c1, s1 = lnq(x2, lnw, lnb, eps)
    qkv = gemm_i8(c1, qw8, s1, qws, qb, BIAS)
    att = attention_heads(qkv, b, s, n_head, scale, causal, valid_len)
    c2, s2 = requant(att, group=g)
    out = gemm_i8(c2, ow8, s2, ows, ob, GROUPED, resid=x2 if residual else None, group=g)
    attn_block_stream.launches += 1
    return out.reshape(b, s, h_out)


def mha_plain(q, k, v, *, n_head: int, scale: float, causal: bool = False):
    """Multi-head attention over separate ``q, k, v [B, S, H]`` -> ``[B, S,
    H]`` in their dtype, in the order of ``mha_pallas``: q * scale in that
    dtype, f32 scores, the clipped softmax, p rounded to that dtype, f32 p.V
    rounded to it."""
    b, s, h = q.shape
    qkv = torch.cat([q, k, v], dim=-1).reshape(b * s, 3 * h)
    out = attention_heads_plain(qkv, b, s, n_head, scale, causal)
    return out.to(q.dtype).reshape(b, s, h)


def mha(q, k, v, *, n_head: int, scale: float, causal: bool = False):
    """Counterpart of ``mha_pallas``: :func:`mha_plain` on the card
    (``ctt_attention`` over three base pointers with row stride H); bf16 or
    f32 in, the same dtype out."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, n_head=n_head, scale=scale, causal=causal)
    b, s, h = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mha: dtype {q.dtype}, expected bfloat16 or float32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.require(t, name, q.dtype, (b, s, h), q.device)
    if h % n_head:
        raise ValueError(f"mha: width {h} does not split into {n_head} heads")
    out = _attention(q, k.data_ptr(), v.data_ptr(), h, b, s, n_head, h // n_head, scale,
                     causal, None, q.dtype, "mha")
    mha.launches += 1
    return out.reshape(b, s, h)


def layer_block_plain(x, l1w, l1b, qw8, qws, qb, ow8, ows, ob, l2w, l2b, up8, upws, upb,
                      dn8, dnws, dnb, *, n_head: int, scale: float, eps: float,
                      act: str = "gelu_quick", causal: bool = False,
                      valid_len: int | None = None):
    """One whole layer over ``x [B, S, H]``: :func:`attn_block_plain` (bias
    and residual) then ``mlp_lnq_plain`` (bias and residual)."""
    b, s, h = x.shape
    xm = attn_block_plain(x, l1w, l1b, qw8, qws, qb, ow8, ows, ob, n_head=n_head, scale=scale,
                          eps=eps, causal=causal, valid_len=valid_len)
    out = mlp_lnq_plain(xm.reshape(b * s, h), l2w, l2b, up8, upws, upb, dn8, dnws, dnb,
                        eps=eps, act=act)
    return out.reshape(b, s, h)


def layer_block(x, l1w, l1b, qw8, qws, qb, ow8, ows, ob, l2w, l2b, up8, upws, upb, dn8, dnws,
                dnb, *, n_head: int, scale: float, eps: float, act: str = "gelu_quick",
                causal: bool = False, valid_len: int | None = None):
    """Counterpart of ``layer_block_pallas``: :func:`layer_block_plain` on
    the card, as :func:`attn_block` then ``mlp_lnq`` (the JAX package calls
    its one-call layer bit-equal on the chip to that two-block chain)."""
    if x.device.type == "cpu":
        return layer_block_plain(x, l1w, l1b, qw8, qws, qb, ow8, ows, ob, l2w, l2b, up8, upws,
                                 upb, dn8, dnws, dnb, n_head=n_head, scale=scale, eps=eps,
                                 act=act, causal=causal, valid_len=valid_len)
    b, s, h = x.shape
    xm = attn_block(x, l1w, l1b, qw8, qws, qb, ow8, ows, ob, n_head=n_head, scale=scale,
                    eps=eps, causal=causal, valid_len=valid_len)
    out = mlp_lnq(xm.reshape(b * s, h), l2w, l2b, up8, upws, upb, dn8, dnws, dnb, eps=eps,
                  act=act)
    layer_block.launches += 1
    return out.reshape(b, s, h)


for _fn in (attention_heads, attn_block, attn_block_stream, layer_block, mha, mha_qkv,
            mha_qkv_i8):
    _fn.launches = 0
