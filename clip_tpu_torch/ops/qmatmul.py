"""Fused dequantize + matmul for block-quantized weights (counterpart of the
JAX package's ``ops/qmatmul_pallas.py:172 qmatmul_pallas``, all three of its
bodies).

``y = x @ dequant(W).T`` with W a 2-D :class:`~.qtensor.QTensor`; on a card
the weights stay packed in device memory and ``csrc/qmatmul.cu`` decodes
them in-kernel.  One wrapper per TPU body, each with its own launch count:

* :func:`qmatmul_q4` -- q4_0 / q4_1 (``_kernel_packed4``);
* :func:`qmatmul_q5` -- q5_0 / q5_1, nibbles plus the high-bit plane
  (``_kernel_packed5``);
* :func:`qmatmul_q8` -- q8_0, signed int8 codes (``_kernel_bytes``).

:func:`qmatmul_plain` is the plain version of all three: the decode of
:func:`~.qtensor.unpack_codes` is format-generic.
"""

from __future__ import annotations

import torch

from ..gguf.constants import QK, GGMLType
from . import _cuda
from .qtensor import QTensor, unpack_codes

__all__ = ["qmatmul_plain", "qmatmul_q4", "qmatmul_q5", "qmatmul_q8"]


def _dequant_in(w: QTensor, cdt: torch.dtype) -> torch.Tensor:
    """Decode as the TPU bodies do, in the compute dtype: codes minus the
    zero point times the block scale (and plus the block min), each step
    rounded to ``cdt``."""
    codes = unpack_codes(w).to(torch.int32).to(cdt)
    if w.zero_point:
        codes = codes - torch.tensor(w.zero_point, dtype=cdt)
    d = torch.repeat_interleave(w.d.to(cdt), QK, dim=-1)
    wd = codes * d
    if w.m is not None:
        wd = wd + torch.repeat_interleave(w.m.to(cdt), QK, dim=-1)
    return wd


def qmatmul_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """``x [M, K]`` in the compute dtype -> ``[M, N]`` in that dtype, float32
    accumulation; any block format."""
    cdt = x.dtype
    wd = _dequant_in(w, cdt)
    return (x.to(torch.float32) @ wd.to(torch.float32).T).to(cdt)


_BITS = {GGMLType.Q4_0: 4, GGMLType.Q4_1: 4, GGMLType.Q5_0: 5, GGMLType.Q5_1: 5,
         GGMLType.Q8_0: 8}


def _launch(x: torch.Tensor, w: QTensor, bits: int, name: str) -> torch.Tensor:
    if _BITS.get(w.qtype) != bits or w.q.dim() != 2:
        raise ValueError(f"{name} takes a 2-D {bits}-bit block weight, got {w.qtype.name} "
                         f"{tuple(w.q.shape)}")
    if x.device.type == "cpu":
        return qmatmul_plain(x, w)
    m, k = x.shape
    n = w.shape[0]
    dev = x.device
    _cuda.require(x, "x", torch.bfloat16, (m, k), dev)
    if bits == 8:
        _cuda.require(w.q, "w.q", torch.int8, (n, k), dev)
    else:
        _cuda.require(w.q, "w.q", torch.uint8, (n, k // 2), dev)
    if bits == 5:
        _cuda.require(w.hb, "w.hb", torch.uint8, (n, k // 8), dev)
    _cuda.require(w.d, "w.d", torch.float32, (n, k // QK), dev)
    if w.m is not None:
        _cuda.require(w.m, "w.m", torch.float32, (n, k // QK), dev)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    _cuda.check(_cuda.lib().ctt_qmatmul(
        x.data_ptr(), w.q.data_ptr(), _cuda.ptr(w.hb), w.d.data_ptr(), _cuda.ptr(w.m),
        out.data_ptr(), m, n, k, w.zero_point, bits, _cuda.stream(x)), name)
    return out


def qmatmul_q4(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """q4 dequant-GEMM (``ctt_qmatmul``, 4 bits): ``x [M, K]`` bf16, W
    q4_0/q4_1 ``[N, K]``."""
    out = _launch(x, w, 4, "qmatmul_q4")
    if x.is_cuda:
        qmatmul_q4.launches += 1
    return out


def qmatmul_q5(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """q5 dequant-GEMM (``ctt_qmatmul``, 5 bits): ``x [M, K]`` bf16, W
    q5_0/q5_1 ``[N, K]``."""
    out = _launch(x, w, 5, "qmatmul_q5")
    if x.is_cuda:
        qmatmul_q5.launches += 1
    return out


def qmatmul_q8(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """q8_0 dequant-GEMM (``ctt_qmatmul``, 8 bits): ``x [M, K]`` bf16, W
    q8_0 ``[N, K]``."""
    out = _launch(x, w, 8, "qmatmul_q8")
    if x.is_cuda:
        qmatmul_q8.launches += 1
    return out


for _fn in (qmatmul_q4, qmatmul_q5, qmatmul_q8):
    _fn.launches = 0
