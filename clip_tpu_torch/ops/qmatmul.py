"""Fused dequantize + matmul for q4_0 / q4_1 weights (counterpart of the
packed4 body of the JAX package's ``ops/qmatmul_pallas.py:172
qmatmul_pallas``).

``y = x @ dequant(W).T`` with W a 2-D :class:`~.qtensor.QTensor`; on a card
the weights stay packed in device memory and ``csrc/qmatmul.cu`` decodes
them in-kernel.  The q5 and q8 bodies of the TPU kernel are not ported yet.
"""

from __future__ import annotations

import torch

from ..gguf.constants import QK
from . import _cuda
from .qtensor import QTensor, unpack_codes

__all__ = ["qmatmul_q4", "qmatmul_q4_plain"]


def _dequant_in(w: QTensor, cdt: torch.dtype) -> torch.Tensor:
    """Decode as ``_kernel_packed4`` does, in the compute dtype: codes minus
    the zero point times the block scale (and plus the block min), each
    step rounded to ``cdt``."""
    codes = unpack_codes(w).to(torch.int32).to(cdt)
    if w.zero_point:
        codes = codes - torch.tensor(w.zero_point, dtype=cdt)
    d = torch.repeat_interleave(w.d.to(cdt), QK, dim=-1)
    wd = codes * d
    if w.m is not None:
        wd = wd + torch.repeat_interleave(w.m.to(cdt), QK, dim=-1)
    return wd


def qmatmul_q4_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """``x [M, K]`` in the compute dtype -> ``[M, N]`` in that dtype, float32
    accumulation."""
    cdt = x.dtype
    wd = _dequant_in(w, cdt)
    return (x.to(torch.float32) @ wd.to(torch.float32).T).to(cdt)


def qmatmul_q4(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """q4 dequant-GEMM (``ctt_qmatmul_q4``): ``x [M, K]`` bf16, W q4_0/q4_1
    ``[N, K]``."""
    if not w.is_packed4 or w.q.dim() != 2:
        raise ValueError(f"qmatmul_q4 takes a 2-D q4_0/q4_1 weight, got {w.qtype.name} "
                         f"{tuple(w.q.shape)}")
    if x.device.type == "cpu":
        return qmatmul_q4_plain(x, w)
    m, k = x.shape
    n = w.shape[0]
    dev = x.device
    _cuda.require(x, "x", torch.bfloat16, (m, k), dev)
    _cuda.require(w.q, "w.q", torch.uint8, (n, k // 2), dev)
    _cuda.require(w.d, "w.d", torch.float32, (n, k // QK), dev)
    if w.m is not None:
        _cuda.require(w.m, "w.m", torch.float32, (n, k // QK), dev)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    _cuda.check(_cuda.lib().ctt_qmatmul_q4(
        x.data_ptr(), w.q.data_ptr(), w.d.data_ptr(), _cuda.ptr(w.m), out.data_ptr(),
        m, n, k, w.zero_point, _cuda.stream(x)), "ctt_qmatmul_q4")
    qmatmul_q4.launches += 1
    return out


qmatmul_q4.launches = 0
