"""Linear layers over dense, block-quantized or per-channel int8 weights.

``qmatmul(x, w)`` computes ``x @ w.T`` for ``w`` a dense ``[N, K]`` tensor, a
:class:`~.qtensor.QTensor` or a :class:`~.qtensor.W8Tensor`, with the routing
of the JAX package's ``ops/linear.py:83-151`` on an accelerator:

* a q4_0/q4_1 2-D weight at 2048 rows or fewer, on a card, goes to the
  fused q4 dequant-GEMM kernel (``ops/qmatmul.py``);
* more rows go to dequantize-then-``torch.matmul``, as the JAX package
  leaves that case to XLA;
* q5 weights (at any row count) and q8 weights (at 2048 rows or fewer) take
  the TPU's fused kernel in the JAX package, whose bodies are not ported:
  they raise ``NotImplementedError`` on a card;
* on the CPU every block format dequantizes, as the JAX package does off
  the TPU.

``kernels=False`` takes the plain versions on any device: the reference
route that a card's kernels are held against.
"""

from __future__ import annotations

import torch

from .qmatmul import qmatmul_q4, qmatmul_q4_plain
from .nn import quant_rows
from .qtensor import QTensor, W8Tensor, dequant

__all__ = ["qmatmul", "w8a8_matmul"]

_KERNEL_MAX_ROWS = 2048


def w8a8_matmul(x: torch.Tensor, w: W8Tensor, compute_dtype=None) -> torch.Tensor:
    """``x [..., K] @ (w.c8 * w.ws).T`` with per-row int8 activations:
    exact int32 accumulation (float64 holds it exactly), then ``acc * sx *
    ws`` in float32, in that order."""
    compute_dtype = compute_dtype or x.dtype
    lead = x.shape[:-1]
    x8, sx = quant_rows(x.reshape(-1, x.shape[-1]))
    acc = x8.to(torch.float64) @ w.c8.to(torch.float64).T
    y = acc.to(torch.float32) * sx[:, None] * w.ws[None, :]
    return y.to(compute_dtype).reshape(*lead, w.c8.shape[0])


def qmatmul(x: torch.Tensor, w, *, compute_dtype=None, kernels: bool = True) -> torch.Tensor:
    """``x [..., K] @ w[N, K].T -> [..., N]`` in ``compute_dtype`` (default
    ``x.dtype``); accumulation is float32."""
    cdt = compute_dtype or x.dtype
    if isinstance(w, W8Tensor):
        return w8a8_matmul(x, w, cdt)
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1]).shape[0]
    if isinstance(w, QTensor):
        fused = w.q.dim() == 2 and rows <= _KERNEL_MAX_ROWS
        if w.is_packed4 and fused and x.is_cuda:
            x2 = x.reshape(rows, -1).to(cdt)
            y = qmatmul_q4(x2, w) if kernels else qmatmul_q4_plain(x2, w)
            return y.reshape(*lead, -1)
        if x.is_cuda and kernels and (w.is_packed5 or fused):
            raise NotImplementedError(
                f"the fused {w.qtype.name} dequant-GEMM is not ported to CUDA yet")
        wd = dequant(w, dtype=cdt)
    else:
        wd = w.to(cdt)
    return torch.matmul(x.to(cdt), wd.T)
