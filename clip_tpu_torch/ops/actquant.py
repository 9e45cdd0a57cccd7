"""The whole-MLP block (counterpart of the JAX package's
``ops/actquant_pallas.py:362 mlp_lnq_pallas``) and the int8 building blocks
it shares with the attention block.

Every wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel (``csrc/actquant.cu``) for a tensor on a card; there
it takes bf16 activations only and raises on anything else.  Each wrapper
counts its launches in ``<wrapper>.launches``.

The plain versions repeat the TPU kernels' arithmetic in the same order:
int8 products accumulate exactly (in float64, which holds every int32 sum
at CLIP widths exactly, since ``torch.matmul`` takes no integer operands on
a card), then ``acc * sx * ws`` in float32, then the epilogue.
"""

from __future__ import annotations

import torch

from . import _cuda
from .nn import layernorm_f32, quant_rows

__all__ = ["ACC", "BIAS", "GELU_QUICK", "GELU_TANH", "RESID", "gemm_i8",
           "gemm_i8_plain", "lnq", "lnq_plain", "mlp_lnq", "mlp_lnq_plain",
           "requant", "requant_plain"]

# epilogue modes of the int8 GEMM (csrc/actquant.cu GemmMode)
ACC, BIAS, GELU_QUICK, GELU_TANH, RESID = 0, 1, 2, 3, 4
_ACT_MODE = {"gelu_quick": GELU_QUICK, "gelu_tanh": GELU_TANH}
_SQRT_2_OVER_PI = 0.7978845608028654


# -- plain versions ----------------------------------------------------------

def lnq_plain(x, w, b, eps: float):
    """LN (f32) + per-row int8 quant: ``x [rows, H]`` -> (codes int8, scales
    f32 ``[rows]``)."""
    return quant_rows(layernorm_f32(x, w, b, eps))


def requant_plain(y):
    return quant_rows(y)


def gemm_i8_plain(a, b, sx, ws, bias, mode: int, resid=None, out_dtype=torch.bfloat16):
    """``a [M, K] int8 . b [N, K]^T int8`` with the epilogue ``mode``."""
    acc = a.to(torch.float64) @ b.to(torch.float64).T
    if mode == ACC:
        return acc.to(torch.int32)
    y = acc.to(torch.float32) * sx[:, None] * ws[None, :]
    if mode == BIAS:
        return (y + bias).to(out_dtype)
    if mode == GELU_QUICK:
        y = y + bias
        return y * (0.5 + 0.5 * torch.tanh(0.851 * y))
    if mode == GELU_TANH:
        y = y + bias
        return 0.5 * y * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (y + 0.044715 * y * y * y)))
    if mode == RESID:
        t = y.to(out_dtype) + bias.to(out_dtype)
        return resid.to(out_dtype) + t
    raise ValueError(f"unknown GEMM mode {mode}")


def mlp_lnq_plain(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb, *, eps: float,
                  act: str = "gelu_quick"):
    """``x + mlp(ln(x))`` for ``x [rows, H]`` in its own dtype: LN -> quant ->
    up GEMM -> +bias -> gelu -> requant -> down GEMM -> +bias -> +x."""
    c1, s1 = lnq_plain(x, lnw, lnb, eps)
    y = gemm_i8_plain(c1, up8, s1, upws, upb, _ACT_MODE[act])
    c2, s2 = requant_plain(y)
    return gemm_i8_plain(c2, dn8, s2, dnws, dnb, RESID, resid=x, out_dtype=x.dtype)


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


def requant(y):
    """Row int8 quant of an f32 ``[rows, N]`` (``ctt_requant``), N % 4 == 0."""
    if y.device.type == "cpu":
        return requant_plain(y)
    rows, n = y.shape
    _cuda.require(y, "y", torch.float32, (rows, n), y.device)
    if n % 4:
        raise ValueError(f"requant: width {n} not a multiple of 4")
    codes = torch.empty(rows, n, dtype=torch.int8, device=y.device)
    scales = torch.empty(rows, dtype=torch.float32, device=y.device)
    _cuda.check(_cuda.lib().ctt_requant(
        y.data_ptr(), codes.data_ptr(), scales.data_ptr(), rows, n, _cuda.stream(y)),
        "ctt_requant")
    requant.launches += 1
    return codes, scales


_GEMM_OUT = {ACC: torch.int32, BIAS: torch.bfloat16, GELU_QUICK: torch.float32,
             GELU_TANH: torch.float32, RESID: torch.bfloat16}


def gemm_i8(a, b, sx, ws, bias, mode: int, resid=None):
    """int8 GEMM with epilogue (``ctt_gemm_i8``): ``a [M, K]``, ``b [N, K]``,
    K % 64 == 0, N % 8 == 0."""
    if a.device.type == "cpu":
        return gemm_i8_plain(a, b, sx, ws, bias, mode, resid=resid)
    if mode not in _GEMM_OUT:
        raise ValueError(f"unknown GEMM mode {mode}")
    m, k = a.shape
    n = b.shape[0]
    dev = a.device
    _cuda.require(a, "a", torch.int8, (m, k), dev)
    _cuda.require(b, "b", torch.int8, (n, k), dev)
    if k % 64 or n % 8:
        raise ValueError(f"gemm_i8: K={k} must be a multiple of 64 and N={n} of 8")
    if mode != ACC:
        _cuda.require(sx, "sx", torch.float32, (m,), dev)
        _cuda.require(ws, "ws", torch.float32, (n,), dev)
        _cuda.require(bias, "bias", torch.float32, (n,), dev)
    if mode == RESID:
        _cuda.require(resid, "resid", torch.bfloat16, (m, n), dev)
    out = torch.empty(m, n, dtype=_GEMM_OUT[mode], device=dev)
    _cuda.check(_cuda.lib().ctt_gemm_i8(
        a.data_ptr(), b.data_ptr(), m, n, k, _cuda.ptr(sx), _cuda.ptr(ws), _cuda.ptr(bias),
        _cuda.ptr(resid) if mode == RESID else None, out.data_ptr(), mode,
        _cuda.stream(a)), "ctt_gemm_i8")
    gemm_i8.launches += 1
    return out


def mlp_lnq(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb, *, eps: float,
            act: str = "gelu_quick"):
    """Whole MLP block with residual: ``x [rows, H]`` -> ``x + mlp(ln(x))``.

    On a card: ``ctt_lnq`` -> up ``ctt_gemm_i8`` (bias + gelu, f32 out) ->
    ``ctt_requant`` -> down ``ctt_gemm_i8`` (bias + residual, bf16 out)."""
    if act not in _ACT_MODE:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return mlp_lnq_plain(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb, eps=eps, act=act)
    rows, h = x.shape
    n = up8.shape[0]
    _cuda.require(up8, "up8", torch.int8, (n, h), x.device)
    _cuda.require(dn8, "dn8", torch.int8, (h, n), x.device)
    c1, s1 = lnq(x, lnw, lnb, eps)
    y = gemm_i8(c1, up8, s1, upws, upb, _ACT_MODE[act])
    c2, s2 = requant(y)
    out = gemm_i8(c2, dn8, s2, dnws, dnb, RESID, resid=x)
    mlp_lnq.launches += 1
    return out


for _fn in (lnq, requant, gemm_i8, mlp_lnq):
    _fn.launches = 0
