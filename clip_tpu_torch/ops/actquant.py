"""The int8 activation-quantized kernels of the JAX package's
``ops/actquant_pallas.py``:

* :func:`mlp_lnq` -- the whole MLP block (``mlp_lnq_pallas:362``);
* :func:`lnq` -- LN + row int8 quant (``lnq_pallas:71``);
* :func:`gemm_gq` -- int8 GEMM -> rescale + bias -> gelu or none -> row
  requant (``gemm_gq_pallas:172``), one kernel (``ctt_gemm_gq``);
* :func:`mlp_gq` -- the MLP from pre-quantized codes, no down bias
  (``mlp_gq_pallas:296``);
* :func:`w8a8_pre` -- the int8 GEMM over pre-quantized codes with the
  ``bf16(acc*sx*ws)`` rescale (``w8a8_pre:658``, XLA in the JAX package);
* :func:`actq` -- activation (gelu_quick, gelu_tanh or none) + row int8
  quant of an f32 or bf16 input (``actq_pallas:119``);
* :func:`mlp_lnq_stream` -- the weight-streamed MLP block
  (``mlp_lnq_stream_pallas:483``): ``exact=True`` is :func:`mlp_lnq`'s
  function, ``exact=False`` requantizes each of ``c`` chunks of 4H with its
  own row scale and sums the down GEMM's per-chunk partials in f32 (the
  grouped GEMM epilogue, ``GROUPED``);

and the int8 building blocks they share with the attention block.  It also
keeps copies of the JAX package's MLP route gates (:func:`fusable_width`,
:func:`mlp_fusable`, :func:`mlp_stream_fusable`): TPU VMEM budgets, copied
only so that the port takes the reference's route (which fixes the function
computed).  No CUDA launch decision depends on them.

Every wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel (``csrc/actquant.cu``, ``csrc/gemm_gq.cu``) for a
tensor on a card; there it takes bf16 activations only and raises on
anything else.  Each wrapper counts its launches in ``<wrapper>.launches``.  Which tile an int8 GEMM
launch takes, and how ``ctt_gemm_gq`` spans a row with a cluster of blocks,
are plain Python (:func:`gemm_plan`, :func:`gq_plan`).

The plain versions repeat the TPU kernels' arithmetic in the same order:
int8 products accumulate exactly (in float64, which holds every int32 sum
at CLIP widths exactly, since ``torch.matmul`` takes no integer operands on
a card), then ``acc * sx * ws`` in float32, then the epilogue.
"""

from __future__ import annotations

import torch

from . import _cuda
from .nn import gelu_quick, gelu_tanh, layernorm_f32, quant_rows

__all__ = ["ACC", "BIAS", "BIAS_F32", "GELU_QUICK", "GELU_TANH", "GEMM_TILES", "GROUPED", "PRE",
           "RESID", "actq", "actq_plain", "fusable_width", "gemm_gq", "gemm_gq_plain", "gemm_i8",
           "gemm_i8_plain", "gemm_plan", "gq_plan", "lnq", "lnq_plain", "mlp_fusable", "mlp_gq",
           "mlp_gq_plain", "mlp_lnq", "mlp_lnq_plain", "mlp_lnq_stream", "mlp_lnq_stream_plain",
           "mlp_stream_fusable", "requant", "requant_plain", "w8a8_pre", "w8a8_pre_plain"]

# epilogue modes of the int8 GEMM (csrc/actquant.cu GemmMode)
ACC, BIAS, GELU_QUICK, GELU_TANH, RESID, PRE, BIAS_F32, GROUPED = 0, 1, 2, 3, 4, 5, 6, 7
_ACT_MODE = {"gelu_quick": GELU_QUICK, "gelu_tanh": GELU_TANH, "none": BIAS_F32}
# activation prologues of ctt_requant (csrc/actquant.cu Act)
_ACT_CODE = {"none": 0, "gelu_quick": 1, "gelu_tanh": 2}


# -- route gates, copied from the JAX package's ops/actquant_pallas.py -------
# TPU VMEM budgets: they decide which route the reference takes (and so
# which function it computes) for a geometry; the port takes the same route.

def fusable_width(h: int) -> bool:
    """``actquant_pallas.py:48``: the row width tiles 128 lanes."""
    return h % 128 == 0


_MLP_MAX_WEIGHT_BYTES = 9 * 1024 * 1024 + 512 * 1024


def _mlp_block_rows(rows: int, n: int, k: int, with_ln: bool) -> "int | None":
    """``actquant_pallas.py:260``."""
    if 2 * n * k > _MLP_MAX_WEIGHT_BYTES:
        return None
    rp = -(-rows // 8) * 8
    return min(256, rp)


def mlp_fusable(h: int, n4h: int) -> bool:
    """``actquant_pallas.py:267``: both int8 MLP weights fit the TPU's
    resident budget (False at ViT-H/14's 1280 x 5120)."""
    return (fusable_width(h) and fusable_width(n4h)
            and _mlp_block_rows(8, n4h, h, True) is not None)


def _mlp_stream_plan(rows: int, k: int, n: int) -> "tuple[int, int] | None":
    """``actquant_pallas.py:448``."""
    if k % 128 != 0 or n % 128 != 0:
        return None
    budget = 13 * 1024 * 1024
    for br in (256, 128, 64, 32, 16, 8):
        for c in (4, 8, 16, 2, 32):
            if n % c or (n // c) % 128:
                continue
            nc = n // c
            chunks = 4 * nc * k
            scratch = br * (5 * k + 4 * n + 12)
            xo = 2 * br * k * 2 * 2
            if chunks + scratch + xo <= budget:
                rp = -(-rows // 8) * 8
                return min(br, rp), c
    return None


def mlp_stream_fusable(h: int, n4h: int) -> bool:
    """``actquant_pallas.py:473``: the weight-streamed MLP kernel (row 9)
    can run this width."""
    return (fusable_width(h) and fusable_width(n4h)
            and _mlp_stream_plan(8, h, n4h) is not None)


# -- launch plans ------------------------------------------------------------
# Plain Python, so that the CPU tests hold them against every shape the
# shipped configurations reach; the kernels take what they are given.

#: streaming multiprocessors of an H100 SXM
N_SMS = 132
#: tiles of ``ctt_gemm_i8`` (``csrc/actquant.cu`` ``Tile``), by preference:
#: (consumer warpgroups, columns); a block owns 64 x warpgroups rows
GEMM_TILES = ((2, 128), (1, 128), (1, 64), (1, 32))
#: ``ctt_gemm_gq`` (``csrc/gemm_gq.cu``): the columns a block may own, its
#: rows, and the largest cluster (16: the non-portable size, which H100
#: allows)
GQ_COLUMNS, GQ_ROWS, GQ_MAX_CLUSTER = (320, 256, 192, 128), 128, 16


def gemm_plan(m: int, n: int, grouped: bool = False) -> int:
    """The tile (an index into :data:`GEMM_TILES`) of an ``[m, K] x [n, K]``
    int8 GEMM: the largest whose grid gives every SM a block, else the
    narrowest (most blocks).  The grouped epilogue keeps an f32 sum beside
    the accumulators, which two warpgroups' registers do not hold, so it
    takes the one-warpgroup tiles.  No split of K: the row counts of the
    shipped shapes reach 132 blocks with the narrow tiles alone."""
    for i, (wg, bn) in enumerate(GEMM_TILES):
        if grouped and wg == 2:
            continue
        if -(-m // (64 * wg)) * -(-n // bn) >= N_SMS:
            return i
    return len(GEMM_TILES) - 1


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def gq_plan(group: int) -> tuple[int, int]:
    """(cluster size, columns a block) with which ``ctt_gemm_gq`` spans a
    requant group of ``group`` columns: one block where one holds the group,
    else the widest block (the fewest bytes of L2 per product) whose
    power-of-two cluster of at most 16 spans the group with every block
    owning columns of it; where none does, the plan that computes the
    fewest columns past the group.  Raises past 16 x 320 = 5120 columns."""
    for cpb in sorted(GQ_COLUMNS):
        if cpb >= group:
            return 1, cpb
    plans = [(_pow2_at_least(-(-group // cpb)), cpb) for cpb in GQ_COLUMNS]
    plans = [(cs, cpb) for cs, cpb in plans if cs <= GQ_MAX_CLUSTER]
    if not plans:
        raise ValueError(f"gemm_gq: a group of {group} columns is wider than "
                         f"{GQ_MAX_CLUSTER * max(GQ_COLUMNS)}")
    for cs, cpb in plans:
        if (cs - 1) * cpb < group:
            return cs, cpb
    return min(plans, key=lambda p: (p[0] * p[1], -p[1]))


# -- plain versions ----------------------------------------------------------

def lnq_plain(x, w, b, eps: float):
    """LN (f32) + per-row int8 quant: ``x [rows, H]`` -> (codes int8, scales
    f32 ``[rows]``)."""
    return quant_rows(layernorm_f32(x, w, b, eps))


def act_f32(y, act: str):
    """``act`` (gelu_quick, gelu_tanh or none) of ``y`` in float32, in the
    order of ``actq_pallas``."""
    fn = {"gelu_quick": gelu_quick, "gelu_tanh": gelu_tanh, "none": lambda v: v}.get(act)
    if fn is None:
        raise ValueError(f"unknown act {act!r}")
    return fn(y.to(torch.float32))


def requant_plain(y, group: int | None = None):
    """Row int8 quant of ``y [rows, N]``: (codes ``[rows, N]``, scales
    ``[rows]``), or with ``group`` each row's ``N / group`` groups of
    columns quantized with their own scale (scales ``[rows, N / group]``),
    as ``_quant_heads`` and the streamed MLP's ``_quantize_rows`` per chunk
    do."""
    if group is None:
        return quant_rows(y)
    rows, n = y.shape
    codes, sx = quant_rows(y.reshape(rows * (n // group), group))
    return codes.reshape(rows, n), sx.reshape(rows, n // group)


def actq_plain(x, act: str = "gelu_quick"):
    """``act`` in float32, then row int8 quant: ``x [rows, N]`` f32 or bf16 ->
    (codes int8 ``[rows, N]``, scales f32 ``[rows]``)."""
    return quant_rows(act_f32(x, act))


def gemm_i8_plain(a, b, sx, ws, bias, mode: int, resid=None, out_dtype=torch.bfloat16,
                  group: int | None = None):
    """``a [M, K] int8 . b [N, K]^T int8`` with the epilogue ``mode``.

    ``GROUPED``: K in groups of ``group`` with row scales ``sx [M, K /
    group]``; the f32 partials ``acc_g * sx[:, g] * ws`` summed in group
    order, rounded to ``out_dtype``, then ``+ bias`` and ``resid +`` in that
    dtype where given (the streamed kernels' emit)."""
    if mode == GROUPED:
        y = None
        for g in range(a.shape[1] // group):
            cols = slice(g * group, (g + 1) * group)
            acc = a[:, cols].to(torch.float64) @ b[:, cols].to(torch.float64).T
            part = acc.to(torch.float32) * sx[:, g, None] * ws[None, :]
            y = part if y is None else y + part
        t = y.to(out_dtype)
        if bias is not None:
            t = t + bias.to(out_dtype)
        return t if resid is None else resid.to(out_dtype) + t
    acc = a.to(torch.float64) @ b.to(torch.float64).T
    if mode == ACC:
        return acc.to(torch.int32)
    y = acc.to(torch.float32) * sx[:, None] * ws[None, :]
    if mode == PRE:
        return y.to(out_dtype)
    if mode == BIAS_F32:
        return y + bias
    if mode == BIAS:
        return (y + bias).to(out_dtype)
    if mode == GELU_QUICK:
        return gelu_quick(y + bias)
    if mode == GELU_TANH:
        return gelu_tanh(y + bias)
    if mode == RESID:
        t = y.to(out_dtype) + bias.to(out_dtype)
        return resid.to(out_dtype) + t
    raise ValueError(f"unknown GEMM mode {mode}")


def w8a8_pre_plain(codes, sx, w8, ws, out_dtype=torch.bfloat16):
    """``codes [M, K] int8 . w8 [N, K]^T`` -> ``acc * sx * ws`` in float32,
    rounded to ``out_dtype``; no bias."""
    return gemm_i8_plain(codes, w8, sx, ws, None, PRE, out_dtype=out_dtype)


def gemm_gq_plain(codes, sx, w8, ws, bias, act: str = "gelu_quick"):
    """int8 GEMM -> ``acc * sx * ws + bias`` in float32 -> ``act`` (gelu_quick,
    gelu_tanh or none) -> row int8 requant: (codes ``[M, N]``, scales
    ``[M]``)."""
    return requant_plain(gemm_i8_plain(codes, w8, sx, ws, bias, _ACT_MODE[act]))


def mlp_gq_plain(codes, sx, up8, upws, upb, dn8, dnws, *, act: str = "gelu_quick",
                 out_dtype=torch.bfloat16):
    """The MLP from pre-quantized codes ``[M, H]``: up GEMM -> + bias -> act
    -> requant -> down GEMM -> ``acc * s2 * dnws`` rounded to ``out_dtype``;
    no down bias, no residual."""
    c2, s2 = gemm_gq_plain(codes, sx, up8, upws, upb, act)
    return w8a8_pre_plain(c2, s2, dn8, dnws, out_dtype)


def mlp_lnq_plain(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb, *, eps: float,
                  act: str = "gelu_quick"):
    """``x + mlp(ln(x))`` for ``x [rows, H]`` in its own dtype: LN -> quant ->
    up GEMM -> +bias -> gelu -> requant -> down GEMM -> +bias -> +x."""
    c1, s1 = lnq_plain(x, lnw, lnb, eps)
    y = gemm_i8_plain(c1, up8, s1, upws, upb, _ACT_MODE[act])
    c2, s2 = requant_plain(y)
    return gemm_i8_plain(c2, dn8, s2, dnws, dnb, RESID, resid=x, out_dtype=x.dtype)


def _stream_chunks(rows: int, h: int, n: int, exact: bool, n_chunks: int | None) -> int:
    """Chunks of 4H the streamed MLP requantizes separately: 1 for
    ``exact``, else ``n_chunks`` or the copied plan's (8 at ViT-H/14)."""
    plan = _mlp_stream_plan(rows, h, n)
    if plan is None:
        raise ValueError(f"mlp_lnq_stream: no chunk plan for {h}x{n}")
    if exact:
        return 1
    c = n_chunks or plan[1]
    if n % c or (n // c) % 128:
        raise ValueError(f"n_chunks {c} must 128-align {n}")
    return c


def mlp_lnq_stream_plain(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb=None, *, eps: float,
                         act: str = "gelu_quick", residual: bool = False, exact: bool = True,
                         n_chunks: int | None = None):
    """The weight-streamed MLP over ``x [rows, H]`` in its own dtype: LN ->
    quant -> up GEMM -> +bias -> act -> requant (full row for ``exact``, per
    chunk of 4H otherwise) -> down GEMM summed over the chunks -> then
    ``+ dnb`` and, with ``residual``, ``x +``."""
    if residual and dnb is None:
        raise ValueError("residual=True requires dnb")
    n = up8.shape[0]
    c = _stream_chunks(x.shape[0], x.shape[1], n, exact, n_chunks)
    c1, s1 = lnq_plain(x, lnw, lnb, eps)
    y = gemm_i8_plain(c1, up8, s1, upws, upb, _ACT_MODE[act])
    c2, s2 = requant_plain(y, group=n // c)
    return gemm_i8_plain(c2, dn8, s2, dnws, dnb, GROUPED, resid=x if residual else None,
                         out_dtype=x.dtype, group=n // c)


# -- kernel wrappers -----------------------------------------------------------

def lnq(x, w, b, eps: float):
    """LN + row int8 quant (``ctt_lnq``): ``x [rows, H]`` bf16, H <= 2048."""
    if x.device.type == "cpu":
        return lnq_plain(x, w, b, eps)
    rows, h = x.shape
    _cuda.require(x, "x", torch.bfloat16, (rows, h), x.device)
    _cuda.require(w, "w", torch.float32, (h,), x.device)
    _cuda.require(b, "b", torch.float32, (h,), x.device)
    if h > 2048:
        raise ValueError(f"lnq: row width {h} > 2048")
    codes = torch.empty(rows, h, dtype=torch.int8, device=x.device)
    scales = torch.empty(rows, dtype=torch.float32, device=x.device)
    _cuda.check(_cuda.lib().ctt_lnq(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        rows, h, float(eps), _cuda.stream(x)), "ctt_lnq")
    lnq.launches += 1
    return codes, scales


def _row_quant(y, group: int, act: str, name: str):
    """Launch ``ctt_requant`` over ``y [rows, N]`` (f32 or bf16): ``act``,
    then int8 codes per group of ``group`` columns; scales ``[rows, N /
    group]``."""
    rows, n = y.shape
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {y.dtype}, expected float32 or bfloat16")
    _cuda.require(y, "y", y.dtype, (rows, n), y.device)
    if group % 4 or n % group:
        raise ValueError(f"{name}: groups of {group} must divide the width {n} and be a "
                         "multiple of 4")
    codes = torch.empty(rows, n, dtype=torch.int8, device=y.device)
    scales = torch.empty(rows, n // group, dtype=torch.float32, device=y.device)
    _cuda.check(_cuda.lib().ctt_requant(
        y.data_ptr(), codes.data_ptr(), scales.data_ptr(), rows, n, group, _ACT_CODE[act],
        int(y.dtype == torch.bfloat16), _cuda.stream(y)), name)
    return codes, scales


def requant(y, group: int | None = None):
    """:func:`requant_plain` on the card (``ctt_requant``): f32 ``y``, N and
    ``group`` multiples of 4."""
    if y.device.type == "cpu":
        return requant_plain(y, group)
    _cuda.require(y, "y", torch.float32, tuple(y.shape), y.device)
    codes, scales = _row_quant(y, y.shape[1] if group is None else group, "none", "requant")
    requant.launches += 1
    return codes, scales.reshape(-1) if group is None else scales


def actq(x, act: str = "gelu_quick"):
    """Counterpart of ``actq_pallas``: :func:`actq_plain` on the card
    (``ctt_requant`` with the activation prologue and the full-row group);
    ``x [rows, N]`` f32 or bf16, N % 4 == 0."""
    if act not in _ACT_CODE:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return actq_plain(x, act)
    codes, scales = _row_quant(x, x.shape[1], act, "actq")
    actq.launches += 1
    return codes, scales.reshape(-1)


_GEMM_OUT = {ACC: torch.int32, BIAS: torch.bfloat16, GELU_QUICK: torch.float32,
             GELU_TANH: torch.float32, RESID: torch.bfloat16, PRE: torch.bfloat16,
             BIAS_F32: torch.float32, GROUPED: torch.bfloat16}


def _require_tma(t, name: str) -> None:
    """TMA reads the int8 operands: base address and row stride 16-byte
    aligned."""
    if t.data_ptr() % 16 or (t.dim() == 2 and t.stride(0) % 16):
        raise ValueError(f"{name}: base address and row stride must be 16-byte aligned (TMA)")


def gemm_i8(a, b, sx, ws, bias, mode: int, resid=None, out_dtype=torch.bfloat16,
            group: int | None = None):
    """int8 GEMM with epilogue (``ctt_gemm_i8``, on the tile of
    :func:`gemm_plan`): ``a [M, K]``, ``b [N, K]``, K % 64 == 0, N % 8 ==
    0, both 16-byte aligned.  ``out_dtype`` is the rounding of the BIAS,
    RESID, PRE and GROUPED epilogues: bfloat16 on a card.  ``GROUPED`` takes
    ``sx [M, K / group]`` with ``group`` a multiple of 64, and an optional
    bias and residual."""
    if a.device.type == "cpu":
        return gemm_i8_plain(a, b, sx, ws, bias, mode, resid=resid, out_dtype=out_dtype,
                             group=group)
    if mode not in _GEMM_OUT:
        raise ValueError(f"unknown GEMM mode {mode}")
    if _GEMM_OUT[mode] == torch.bfloat16 and out_dtype != torch.bfloat16:
        raise TypeError(f"gemm_i8: mode {mode} writes bfloat16 on a card, not {out_dtype}")
    m, k = a.shape
    n = b.shape[0]
    dev = a.device
    _cuda.require(a, "a", torch.int8, (m, k), dev)
    _cuda.require(b, "b", torch.int8, (n, k), dev)
    if k % 64 or k == 0 or n % 8:
        raise ValueError(f"gemm_i8: K={k} must be a positive multiple of 64 and N={n} of 8")
    _require_tma(a, "a")
    _require_tma(b, "b")
    if mode == GROUPED:
        if group is None or group % 64 or k % group:
            raise ValueError(f"gemm_i8: groups of {group} must divide K={k} and be a "
                             "multiple of 64")
        _cuda.require(sx, "sx", torch.float32, (m, k // group), dev)
    elif mode != ACC:
        _cuda.require(sx, "sx", torch.float32, (m,), dev)
    if mode != ACC:
        _cuda.require(ws, "ws", torch.float32, (n,), dev)
    if mode not in (ACC, PRE) and (mode != GROUPED or bias is not None):
        _cuda.require(bias, "bias", torch.float32, (n,), dev)
    if mode == RESID or (mode == GROUPED and resid is not None):
        _cuda.require(resid, "resid", torch.bfloat16, (m, n), dev)
    out = torch.empty(m, n, dtype=_GEMM_OUT[mode], device=dev)
    _cuda.check(_cuda.lib().ctt_gemm_i8(
        a.data_ptr(), b.data_ptr(), m, n, k, _cuda.ptr(sx), _cuda.ptr(ws),
        _cuda.ptr(bias) if mode not in (ACC, PRE) else None,
        _cuda.ptr(resid) if mode in (RESID, GROUPED) else None, out.data_ptr(), mode,
        group or k, gemm_plan(m, n, mode == GROUPED), _cuda.stream(a)), "ctt_gemm_i8")
    gemm_i8.launches += 1
    return out


def _gemm_gq(codes, sx, w8, ws, bias, act: str, group: int):
    """Launch ``ctt_gemm_gq``: ``act(codes . w8^T * sx * ws + bias)``
    requantized per group of ``group`` columns -> (codes int8 ``[M, N]``,
    scales f32 ``[M, N / group]``).  Counts in ``gemm_gq.launches``."""
    m, k = codes.shape
    n = w8.shape[0]
    dev = codes.device
    _cuda.require(codes, "codes", torch.int8, (m, k), dev)
    _cuda.require(w8, "w8", torch.int8, (n, k), dev)
    _cuda.require(sx, "sx", torch.float32, (m,), dev)
    _cuda.require(ws, "ws", torch.float32, (n,), dev)
    _cuda.require(bias, "bias", torch.float32, (n,), dev)
    if k % 64 or k == 0 or group % 8 or n % group:
        raise ValueError(f"gemm_gq: K={k} must be a positive multiple of 64, and groups of "
                         f"{group} a multiple of 8 that divides N={n}")
    _require_tma(codes, "codes")
    _require_tma(w8, "w8")
    cs, cpb = gq_plan(group)
    out = torch.empty(m, n, dtype=torch.int8, device=dev)
    scales = torch.empty(m, n // group, dtype=torch.float32, device=dev)
    _cuda.check(_cuda.lib().ctt_gemm_gq(
        codes.data_ptr(), w8.data_ptr(), m, n, k, sx.data_ptr(), ws.data_ptr(), bias.data_ptr(),
        out.data_ptr(), scales.data_ptr(), _ACT_MODE[act], group, cs, cpb, _cuda.stream(codes)),
        "ctt_gemm_gq")
    gemm_gq.launches += 1
    return out, scales


def mlp_lnq(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb, *, eps: float,
            act: str = "gelu_quick"):
    """Whole MLP block with residual: ``x [rows, H]`` -> ``x + mlp(ln(x))``.

    On a card: ``ctt_lnq`` -> ``ctt_gemm_gq`` (up GEMM, bias, act and the
    full-row requant in one kernel: no f32 row in device memory) -> down
    ``ctt_gemm_i8`` (bias + residual, bf16 out)."""
    if act not in _ACT_MODE:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return mlp_lnq_plain(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb, eps=eps, act=act)
    rows, h = x.shape
    n = up8.shape[0]
    _cuda.require(up8, "up8", torch.int8, (n, h), x.device)
    _cuda.require(dn8, "dn8", torch.int8, (h, n), x.device)
    c1, s1 = lnq(x, lnw, lnb, eps)
    c2, s2 = _gemm_gq(c1, s1, up8, upws, upb, act, n)
    out = gemm_i8(c2, dn8, s2.reshape(-1), dnws, dnb, RESID, resid=x)
    mlp_lnq.launches += 1
    return out


def mlp_lnq_stream(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb=None, *, eps: float,
                   act: str = "gelu_quick", residual: bool = False, exact: bool = True,
                   n_chunks: int | None = None):
    """Counterpart of ``mlp_lnq_stream_pallas``: :func:`mlp_lnq_stream_plain`
    on the card.  ``ctt_lnq`` -> ``ctt_gemm_gq`` (up GEMM, bias, act and the
    requant over the full row for ``exact``, or per chunk of 4H / c, on
    chip) -> down ``ctt_gemm_i8`` with the grouped epilogue.  One chunk with
    the residual is :func:`mlp_lnq`'s chain, so it ends in that residual
    epilogue, which the grouped one equals bit for bit with one group.

    The TPU kernel streams the weight columns through VMEM in chunks; here
    every GEMM streams its weights from device memory anyway, so only the
    per-chunk numerics of ``exact=False`` need a kernel of their own (the
    grouped requant and epilogue)."""
    if act not in _ACT_MODE:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return mlp_lnq_stream_plain(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb, eps=eps,
                                    act=act, residual=residual, exact=exact,
                                    n_chunks=n_chunks)
    if residual and dnb is None:
        raise ValueError("residual=True requires dnb")
    rows, h = x.shape
    n = up8.shape[0]
    _cuda.require(up8, "up8", torch.int8, (n, h), x.device)
    _cuda.require(dn8, "dn8", torch.int8, (h, n), x.device)
    c = _stream_chunks(rows, h, n, exact, n_chunks)
    c1, s1 = lnq(x, lnw, lnb, eps)
    c2, s2 = _gemm_gq(c1, s1, up8, upws, upb, act, n // c)
    if c == 1 and residual:
        out = gemm_i8(c2, dn8, s2.reshape(-1), dnws, dnb, RESID, resid=x)
    else:
        out = gemm_i8(c2, dn8, s2, dnws, dnb, GROUPED, resid=x if residual else None,
                      group=n // c)
    mlp_lnq_stream.launches += 1
    return out


def w8a8_pre(codes, sx, w8, ws, out_dtype=torch.bfloat16):
    """Counterpart of the JAX package's ``w8a8_pre``: ``codes [M, K]`` int8
    with row scales ``sx [M]`` times ``w8 [N, K]`` -> ``bf16(acc * sx * ws)``
    (``ctt_gemm_i8``, PRE epilogue, on a card)."""
    if codes.device.type == "cpu":
        return w8a8_pre_plain(codes, sx, w8, ws, out_dtype)
    out = gemm_i8(codes, w8, sx, ws, None, PRE, out_dtype=out_dtype)
    w8a8_pre.launches += 1
    return out


def gemm_gq(codes, sx, w8, ws, bias, act: str = "gelu_quick"):
    """Counterpart of ``gemm_gq_pallas``: ``codes [M, K]`` int8 (row scales
    ``sx [M]``) times ``w8 [N, K]`` -> ``acc * sx * ws + bias`` in float32 ->
    ``act`` -> row int8 requant over the full row: (codes ``[M, N]``, scales
    ``[M]``).

    On a card: one ``ctt_gemm_gq`` launch.  The row amax spans all N
    columns, more than one block holds, so a cluster of blocks along N spans
    the row (:func:`gq_plan`): each keeps its f32 act(y) in shared memory,
    and the blocks meet their row maxima through distributed shared memory.
    Codes and scales equal ``requant(gemm_i8(...))`` bit for bit."""
    if act not in _ACT_MODE:
        raise ValueError(f"unknown act {act!r}")
    if codes.device.type == "cpu":
        return gemm_gq_plain(codes, sx, w8, ws, bias, act)
    out, scales = _gemm_gq(codes, sx, w8, ws, bias, act, w8.shape[0])
    return out, scales.reshape(-1)


def mlp_gq(codes, sx, up8, upws, upb, dn8, dnws, *, act: str = "gelu_quick",
           out_dtype=torch.bfloat16):
    """Counterpart of ``mlp_gq_pallas``: the MLP from pre-quantized codes
    ``[M, H]`` -> ``[M, H]`` in ``out_dtype``, without the down bias.

    On a card: :func:`gemm_gq` (``ctt_gemm_gq``) -> down ``ctt_gemm_i8``
    with the PRE epilogue."""
    if act not in _ACT_MODE:
        raise ValueError(f"unknown act {act!r}")
    if codes.device.type == "cpu":
        return mlp_gq_plain(codes, sx, up8, upws, upb, dn8, dnws, act=act, out_dtype=out_dtype)
    m, h = codes.shape
    n = up8.shape[0]
    _cuda.require(up8, "up8", torch.int8, (n, h), codes.device)
    _cuda.require(dn8, "dn8", torch.int8, (h, n), codes.device)
    c2, s2 = gemm_gq(codes, sx, up8, upws, upb, act)
    out = w8a8_pre(c2, s2, dn8, dnws, out_dtype)
    mlp_gq.launches += 1
    return out


for _fn in (lnq, requant, actq, gemm_i8, mlp_lnq, mlp_lnq_stream, w8a8_pre, gemm_gq, mlp_gq):
    _fn.launches = 0
