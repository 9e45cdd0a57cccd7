"""Linear layers over dense, block-quantized or per-channel int8 weights.

``qmatmul(x, w)`` computes ``x @ w.T`` for ``w`` a dense ``[N, K]`` tensor, a
:class:`~.qtensor.QTensor` or a :class:`~.qtensor.W8Tensor`, with the routing
of the JAX package's ``ops/linear.py:83-151`` on an accelerator
(:func:`fused_route`):

* a 2-D q5_0/q5_1 weight at any row count, and a 2-D q4_0/q4_1/q8_0 weight
  at 2048 rows or fewer, go on a card to the fused dequant-GEMM kernel of
  their format (``ops/qmatmul.py``);
* other block-quantized cases dequantize, then ``torch.matmul``, as the
  JAX package leaves them to XLA;
* a dense weight is ``torch.matmul`` in the compute dtype, outside any
  kernel, as the JAX package leaves it to XLA;
* on the CPU every block format dequantizes, as the JAX package does off
  the TPU;
* a :class:`~.qtensor.W8Tensor` that keeps its block-quantized source goes
  on a card, at 2048 rows or fewer, to the dequant-GEMM kernel of the
  source's format (``ops/linear.py:123-138``); otherwise it takes
  :func:`w8a8_matmul`, whose int8 product runs on a card in the port's
  ``gemm_i8`` kernel (``ops.actquant.w8a8_pre``).

``kernels=False`` takes the plain versions on any device: the reference
route that a card's kernels are held against.
"""

from __future__ import annotations

import torch

from .actquant import w8a8_pre, w8a8_pre_plain
from .nn import quant_rows
from .qmatmul import qmatmul_plain, qmatmul_q4, qmatmul_q5, qmatmul_q8
from .qtensor import QTensor, W8Tensor, dequant

__all__ = ["fused_route", "qmatmul", "source_route", "w8a8_matmul"]

_KERNEL_MAX_ROWS = 2048


def w8a8_matmul(x: torch.Tensor, w: W8Tensor, compute_dtype=None,
                kernels: bool = True) -> torch.Tensor:
    """``x [..., K] @ (w.c8 * w.ws).T`` with per-row int8 activations (the
    row quant in plain PyTorch, as the JAX package leaves it to XLA): exact
    int32 accumulation, then ``acc * sx * ws`` in float32, in that order,
    rounded to ``compute_dtype``."""
    compute_dtype = compute_dtype or x.dtype
    lead = x.shape[:-1]
    x8, sx = quant_rows(x.reshape(-1, x.shape[-1]))
    fn = w8a8_pre if kernels else w8a8_pre_plain
    return fn(x8, sx, w.c8, w.ws, compute_dtype).reshape(*lead, w.c8.shape[0])


def fused_route(w, rows: int) -> bool:
    """True where the JAX package's ``auto`` backend on a TPU sends ``x
    [rows, K] @ w.T`` to ``qmatmul_pallas`` (``ops/linear.py:83-100
    _resolve``): a 2-D block weight, q5 at any row count, others at 2048
    rows or fewer."""
    if not isinstance(w, QTensor) or w.q.ndim != 2:
        return False
    return w.is_packed5 or rows <= _KERNEL_MAX_ROWS


def source_route(w: W8Tensor, rows: int) -> bool:
    """True where the JAX package on a TPU sends ``x [rows, K] @ w.T`` for a
    W8Tensor to ``qmatmul_pallas`` on its kept source (``ops/linear.py:
    133-137``): a kept source and 2048 rows or fewer.  The port takes that
    route on a card."""
    return w.qt is not None and rows <= _KERNEL_MAX_ROWS


def _kernel_for(w: QTensor):
    if w.is_packed4:
        return qmatmul_q4
    return qmatmul_q5 if w.is_packed5 else qmatmul_q8


def qmatmul(x: torch.Tensor, w, *, compute_dtype=None, kernels: bool = True) -> torch.Tensor:
    """``x [..., K] @ w[N, K].T -> [..., N]`` in ``compute_dtype`` (default
    ``x.dtype``); accumulation is float32."""
    cdt = compute_dtype or x.dtype
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1]).shape[0]
    if isinstance(w, W8Tensor):
        if not (x.is_cuda and source_route(w, rows)):
            return w8a8_matmul(x, w, cdt, kernels)
        w = w.qt
    if x.is_cuda and fused_route(w, rows):
        x2 = x.reshape(rows, -1).to(cdt)
        y = _kernel_for(w)(x2, w) if kernels else qmatmul_plain(x2, w)
        return y.reshape(*lead, -1)
    wd = dequant(w, dtype=cdt) if isinstance(w, QTensor) else w.to(cdt)
    return torch.matmul(x.to(cdt), wd.T)
