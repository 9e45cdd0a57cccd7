"""Block-quantized and per-channel int8 weight tensors.

Same layouts as the JAX package's ``ops/qtensor.py`` (all blocks are 32
elements along the last, contracting axis, matching the GGUF blocking):

* q4_0 / q4_1 — ``q``: uint8 ``[..., K/2]``; byte ``j`` packs element ``2j``
  in its low nibble and ``2j+1`` in its high nibble (repacked from ggml's
  j/j+16 interleave at load time).
* q5_0 / q5_1 — the 4 low bits nibble-packed like q4 plus ``hb``: the high
  bit as a little-endian bit plane (uint8 ``[..., K/8]``).
* q8_0 — ``q``: int8 ``[..., K]``.

``d`` (scale) and ``m`` (min, q4_1/q5_1 only) are float32 ``[..., K/32]``:
fp16 values upcast exactly, so dequantization is bit-identical to the numpy
oracle in ``quant.formats``.

The fields are numpy arrays while a checkpoint is loaded and re-quantized on
the host (:func:`from_ggml_blocks`, :func:`dequant_np`, :func:`to_w8tensor`
stay numpy, so the int8 codes and scales equal the JAX package's by
construction) and torch tensors once :meth:`QTensor.to` has moved them to a
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..gguf.constants import QK, GGMLType
from ..quant import block_fields

__all__ = ["QTensor", "W8Tensor", "from_ggml_blocks", "dequant", "dequant_np",
           "take_rows", "to_w8tensor"]

_ZERO_POINT = {
    GGMLType.Q4_0: 8,
    GGMLType.Q4_1: 0,
    GGMLType.Q5_0: 16,
    GGMLType.Q5_1: 0,
    GGMLType.Q8_0: 0,
}


def _to_torch(a, device) -> Any:
    if a is None or isinstance(a, torch.Tensor):
        return None if a is None else a.to(device)
    return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(device)


@dataclass
class QTensor:
    """Block-quantized tensor; logical shape is ``d.shape[:-1] + (K,)``."""

    q: Any                 # packed codes, see module docstring
    d: Any                 # float32 scales [..., K/32]
    m: Any                 # float32 mins [..., K/32] or None
    qtype: GGMLType
    hb: Any = None         # high-bit plane uint8 [..., K/8] (q5 only)

    @property
    def shape(self) -> tuple[int, ...]:
        lead = tuple(self.d.shape[:-1])
        return lead + (self.d.shape[-1] * QK,)

    @property
    def is_packed4(self) -> bool:
        return self.qtype in (GGMLType.Q4_0, GGMLType.Q4_1)

    @property
    def is_packed5(self) -> bool:
        return self.qtype in (GGMLType.Q5_0, GGMLType.Q5_1)

    @property
    def zero_point(self) -> int:
        return _ZERO_POINT[self.qtype]

    def to(self, device) -> "QTensor":
        return QTensor(q=_to_torch(self.q, device), d=_to_torch(self.d, device),
                       m=_to_torch(self.m, device), qtype=self.qtype,
                       hb=_to_torch(self.hb, device))


@dataclass
class W8Tensor:
    """Per-channel int8 weight: ``c8`` int8 ``[..., N, K]`` and ``ws`` float32
    ``[..., N]``, ``W ≈ c8 * ws[..., None]``.  Derived from a block-quantized
    :class:`QTensor` at load time (:func:`to_w8tensor`) and consumed by the
    int8 GEMMs of the attention and MLP blocks, which quantize activations
    per row."""

    c8: Any
    ws: Any
    qtype: GGMLType        # source format, for reporting only

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.c8.shape)

    def to(self, device) -> "W8Tensor":
        return W8Tensor(c8=_to_torch(self.c8, device),
                        ws=_to_torch(self.ws, device), qtype=self.qtype)

    def __getitem__(self, i) -> "W8Tensor":
        """Slice the leading (layer) axis."""
        return W8Tensor(c8=self.c8[i], ws=self.ws[i], qtype=self.qtype)


def dequant_np(qt: QTensor) -> np.ndarray:
    """Host-side (numpy) dequantization, for one-time load transforms.
    Mirrors :func:`dequant` exactly."""
    q = np.asarray(qt.q)
    if qt.is_packed4 or qt.is_packed5:
        lo = q & np.uint8(0x0F)
        hi = q >> np.uint8(4)
        q = np.stack([lo, hi], axis=-1).reshape(*q.shape[:-1], q.shape[-1] * 2)
    if qt.is_packed5:
        k = q.shape[-1]
        plane = np.repeat(np.asarray(qt.hb), 8, axis=-1).astype(np.int32)
        bit = (plane >> (np.arange(k, dtype=np.int32) % 8)) & 1
        q = q.astype(np.int32) | (bit << 4)
    codes = q.astype(np.float32)
    if qt.zero_point:
        codes = codes - float(qt.zero_point)
    k = codes.shape[-1]
    blocks = codes.reshape(*codes.shape[:-1], k // QK, QK)
    w = blocks * np.asarray(qt.d)[..., None]
    if qt.m is not None:
        w = w + np.asarray(qt.m)[..., None]
    return w.reshape(*codes.shape[:-1], k).astype(np.float32)


def to_w8tensor(qt) -> W8Tensor:
    """Re-quantize a weight to per-channel int8 on the host (numpy).

    Accepts a block-quantized :class:`QTensor` of numpy arrays or a dense
    ``[..., N, K]`` array.  The per-channel scale is ``amax_K |W| / 127``."""
    if isinstance(qt, QTensor):
        w, qtype = dequant_np(qt), qt.qtype
    else:
        w = np.asarray(qt, dtype=np.float32)
        qtype = GGMLType.F16
    ws = np.abs(w).max(axis=-1) / 127.0
    ws = np.maximum(ws, 1e-12)
    c8 = np.clip(np.rint(w / ws[..., None]), -127, 127).astype(np.int8)
    return W8Tensor(c8=c8, ws=ws.astype(np.float32), qtype=qtype)


def from_ggml_blocks(
    packed: np.ndarray, shape: tuple[int, ...], qtype: GGMLType
) -> QTensor:
    """Convert a GGUF packed block buffer (host numpy) to the device layout
    (still numpy; :meth:`QTensor.to` moves it).

    ``shape`` is the logical row-major shape; its last axis is the blocked
    (contraction) axis and must be a multiple of 32.
    """
    qtype = GGMLType(qtype)
    f = block_fields(packed, qtype)
    k = shape[-1]
    if k % QK:
        raise ValueError(f"last axis {k} not a multiple of {QK}")
    lead = shape[:-1]
    nb_per_row = k // QK

    codes = f.q.reshape(*lead, k)  # element order
    hb = None
    if qtype in (GGMLType.Q4_0, GGMLType.Q4_1):
        pairs = codes.reshape(*lead, k // 2, 2).astype(np.uint8)
        q = (pairs[..., 0] | (pairs[..., 1] << 4)).astype(np.uint8)
    elif qtype in (GGMLType.Q5_0, GGMLType.Q5_1):
        lo = (codes & 0x0F).astype(np.uint8)
        pairs = lo.reshape(*lead, k // 2, 2)
        q = (pairs[..., 0] | (pairs[..., 1] << 4)).astype(np.uint8)
        bits = (codes >> 4).astype(np.uint8)          # the 5th bit, 0/1
        hb = np.packbits(bits, axis=-1, bitorder="little")  # [..., K/8]
    else:
        q = codes.astype(np.int8)

    d = f.d.astype(np.float32).reshape(*lead, nb_per_row)
    m = None
    if f.m is not None:
        m = f.m.astype(np.float32).reshape(*lead, nb_per_row)
    return QTensor(q=q, d=d, m=m, qtype=qtype, hb=hb)


def unpack_codes(qt: QTensor) -> torch.Tensor:
    """Integer codes in element order, shape ``[..., K]`` (torch tensors)."""
    q = qt.q
    if qt.is_packed4 or qt.is_packed5:
        lo = q & 0x0F
        hi = q >> 4
        q = torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1], q.shape[-1] * 2)
    if qt.is_packed5:
        k = q.shape[-1]
        plane = torch.repeat_interleave(qt.hb, 8, dim=-1).to(torch.int32)
        shifts = torch.arange(k, dtype=torch.int32, device=q.device) % 8
        bit = (plane >> shifts) & 1
        q = q.to(torch.int32) | (bit << 4)
    return q


def dequant(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantize to a dense tensor (numerically identical to the numpy
    oracle when ``dtype`` is float32)."""
    codes = unpack_codes(qt).to(torch.float32)
    if qt.zero_point:
        codes = codes - float(qt.zero_point)
    k = codes.shape[-1]
    blocks = codes.reshape(*codes.shape[:-1], k // QK, QK)
    w = blocks * qt.d[..., None]
    if qt.m is not None:
        w = w + qt.m[..., None]
    return w.reshape(*codes.shape[:-1], k).to(dtype)


def take_rows(qt_or_arr, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Embedding gather: select rows by id, dequantizing only the gathered
    rows when the table is quantized.  Ids are clamped into range, as the
    JAX package's ``mode="clip"`` gather does."""
    n = qt_or_arr.shape[0]
    ids = ids.clamp(0, n - 1)
    if not isinstance(qt_or_arr, QTensor):
        return qt_or_arr[ids].to(dtype)
    qt = qt_or_arr
    sub = QTensor(
        q=qt.q[ids], d=qt.d[ids],
        m=None if qt.m is None else qt.m[ids],
        qtype=qt.qtype,
        hb=None if qt.hb is None else qt.hb[ids],
    )
    return dequant(sub, dtype=dtype)
