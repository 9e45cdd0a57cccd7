"""ggml block-quantization formats: q4_0, q4_1, q5_0, q5_1, q8_0.

Vectorized numpy implementations of the pack/unpack/quantize semantics of the
ggml kernels invoked by the reference quantizer
(upstream clip.cpp:1771-1791).  All formats quantize independent blocks
of 32 contiguous elements along the innermost dimension:

====== ======================= ==========================================
type   block layout (LE bytes) dequantization
====== ======================= ==========================================
q4_0   d:f16, qs:16B nibbles    x = (q - 8) * d            q in [0, 15]
q4_1   d:f16, m:f16, qs:16B     x = q * d + m              q in [0, 15]
q5_0   d:f16, qh:u32, qs:16B    x = (q - 16) * d           q in [0, 31]
q5_1   d:f16, m:f16, qh:u32,qs  x = q * d + m              q in [0, 31]
q8_0   d:f16, qs:32 int8        x = q * d                  q in [-127,127]
====== ======================= ==========================================

Nibble packing: byte ``j`` of ``qs`` holds element ``j`` in its low nibble and
element ``j+16`` in its high nibble.  For q5, bit ``i`` of ``qh`` is the 5th
(high) bit of element ``i``.

Rounding matches ggml: q4_0/q5_0 use ``trunc(x/d + {8.5,16.5})`` (d carries the
sign of the absmax element so the grid is asymmetric), q4_1/q5_1 use
``trunc((x-min)/d + 0.5)`` and q8_0 uses round-half-away-from-zero.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..gguf.constants import GGML_TYPE_SIZES, QK, GGMLType

__all__ = [
    "QK",
    "quantize",
    "dequantize",
    "quantize_with_hist",
    "QUANT_TYPES",
]

QUANT_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0)


def _to_blocks(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % QK != 0:
        raise ValueError(f"element count {x.size} not a multiple of QK={QK}")
    return x.reshape(-1, QK)


def _signed_absmax(xb: np.ndarray) -> np.ndarray:
    """Per-block signed value of the element with the largest magnitude,
    breaking ties like ggml's sequential scan (first strictly-larger wins)."""
    idx = np.argmax(np.abs(xb), axis=1)
    return xb[np.arange(xb.shape[0]), idx]


def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    """q: (nb, 32) uint8 in [0,31] -> (nb, 16) bytes, ggml interleave."""
    lo = q[:, :16] & 0x0F
    hi = q[:, 16:] & 0x0F
    return (lo | (hi << 4)).astype(np.uint8)


def _unpack_nibbles(qs: np.ndarray) -> np.ndarray:
    """(nb, 16) packed bytes -> (nb, 32) uint8 low-4-bit values."""
    lo = qs & 0x0F
    hi = qs >> 4
    return np.concatenate([lo, hi], axis=1)


def _pack_high_bits(q: np.ndarray) -> np.ndarray:
    """5th bit of each of 32 elements -> (nb,) uint32 (bit i = element i)."""
    bits = (q >> 4).astype(np.uint32) & 1
    shifts = np.arange(QK, dtype=np.uint32)
    return (bits << shifts).sum(axis=1, dtype=np.uint32)


def _unpack_high_bits(qh: np.ndarray) -> np.ndarray:
    """(nb,) uint32 -> (nb, 32) uint8 with the 5th bit in position 4."""
    shifts = np.arange(QK, dtype=np.uint32)
    bits = (qh[:, None] >> shifts) & 1
    return (bits << 4).astype(np.uint8)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------


def _quantize_q4_0(xb: np.ndarray) -> np.ndarray:
    nb = xb.shape[0]
    smax = _signed_absmax(xb)
    d = smax / -8.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.minimum(15, np.trunc(xb * inv[:, None] + 8.5).astype(np.int32))
    q = np.maximum(0, q).astype(np.uint8)
    out = np.zeros((nb, 18), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = _pack_nibbles(q)
    return out


def _quantize_q4_1(xb: np.ndarray) -> np.ndarray:
    nb = xb.shape[0]
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.minimum(15, np.trunc((xb - mn[:, None]) * inv[:, None] + 0.5).astype(np.int32))
    q = np.maximum(0, q).astype(np.uint8)
    out = np.zeros((nb, 20), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:] = _pack_nibbles(q)
    return out


def _quantize_q5_0(xb: np.ndarray) -> np.ndarray:
    nb = xb.shape[0]
    smax = _signed_absmax(xb)
    d = smax / -16.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.minimum(31, np.trunc(xb * inv[:, None] + 16.5).astype(np.int32))
    q = np.maximum(0, q).astype(np.uint8)
    out = np.zeros((nb, 22), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:6] = _pack_high_bits(q)[:, None].view(np.uint8)
    out[:, 6:] = _pack_nibbles(q)
    return out


def _quantize_q5_1(xb: np.ndarray) -> np.ndarray:
    nb = xb.shape[0]
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 31.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.minimum(31, np.trunc((xb - mn[:, None]) * inv[:, None] + 0.5).astype(np.int32))
    q = np.maximum(0, q).astype(np.uint8)
    out = np.zeros((nb, 24), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:8] = _pack_high_bits(q)[:, None].view(np.uint8)
    out[:, 8:] = _pack_nibbles(q)
    return out


def _quantize_q8_0(xb: np.ndarray) -> np.ndarray:
    nb = xb.shape[0]
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    scaled = xb * inv[:, None]
    # round half away from zero (C roundf), unlike numpy's banker's rounding
    q = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    q = np.clip(q, -128, 127).astype(np.int8)
    out = np.zeros((nb, 34), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out


_QUANTIZERS = {
    GGMLType.Q4_0: _quantize_q4_0,
    GGMLType.Q4_1: _quantize_q4_1,
    GGMLType.Q5_0: _quantize_q5_0,
    GGMLType.Q5_1: _quantize_q5_1,
    GGMLType.Q8_0: _quantize_q8_0,
}


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Quantize a float array to packed blocks of the given type.

    Returns a ``(n_blocks, block_nbytes)`` uint8 array; block ``i`` covers
    elements ``[32*i, 32*(i+1))`` of the flattened input.
    """
    ggml_type = GGMLType(ggml_type)
    if ggml_type not in _QUANTIZERS:
        raise ValueError(f"not a supported quantized type: {ggml_type!r}")
    return _QUANTIZERS[ggml_type](_to_blocks(x))


# ---------------------------------------------------------------------------
# dequantize / structured views
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockFields:
    """Structured numpy views over a packed block buffer."""

    d: np.ndarray                 # (nb,) float16 scale
    q: np.ndarray                 # (nb, 32) integer codes (uint8 or int8)
    m: np.ndarray | None = None   # (nb,) float16 min (q4_1 / q5_1)
    zero_point: int = 0           # subtract before scaling (q4_0: 8, q5_0: 16)


def block_fields(packed: np.ndarray, ggml_type: GGMLType) -> BlockFields:
    """Decode a packed block buffer into (scales, codes, mins)."""
    ggml_type = GGMLType(ggml_type)
    block_bytes, _ = GGML_TYPE_SIZES[ggml_type]
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1, block_bytes)
    d = packed[:, 0:2].copy().view(np.float16)[:, 0]
    if ggml_type == GGMLType.Q4_0:
        return BlockFields(d=d, q=_unpack_nibbles(packed[:, 2:]), zero_point=8)
    if ggml_type == GGMLType.Q4_1:
        m = packed[:, 2:4].copy().view(np.float16)[:, 0]
        return BlockFields(d=d, q=_unpack_nibbles(packed[:, 4:]), m=m)
    if ggml_type == GGMLType.Q5_0:
        qh = packed[:, 2:6].copy().view(np.uint32)[:, 0]
        q = _unpack_nibbles(packed[:, 6:]) | _unpack_high_bits(qh)
        return BlockFields(d=d, q=q, zero_point=16)
    if ggml_type == GGMLType.Q5_1:
        m = packed[:, 2:4].copy().view(np.float16)[:, 0]
        qh = packed[:, 4:8].copy().view(np.uint32)[:, 0]
        q = _unpack_nibbles(packed[:, 8:]) | _unpack_high_bits(qh)
        return BlockFields(d=d, q=q, m=m)
    if ggml_type == GGMLType.Q8_0:
        return BlockFields(d=d, q=packed[:, 2:].copy().view(np.int8))
    raise ValueError(f"not a supported quantized type: {ggml_type!r}")


def dequantize(packed: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Dequantize packed blocks to a flat float32 array."""
    f = block_fields(packed, ggml_type)
    d = f.d.astype(np.float32)[:, None]
    q = f.q.astype(np.float32)
    if f.m is not None:
        return (q * d + f.m.astype(np.float32)[:, None]).reshape(-1)
    return ((q - f.zero_point) * d).reshape(-1)


def quantize_with_hist(x: np.ndarray, ggml_type: GGMLType) -> tuple[np.ndarray, np.ndarray]:
    """Quantize and also return a 16-bin histogram of code values.

    The reference prints the same kind of informational histogram after
    quantizing (upstream clip.cpp:1827-1841).  Codes are folded into 16
    bins: 4-bit codes directly, 5-bit codes halved, int8 codes shifted+scaled.
    """
    packed = quantize(x, ggml_type)
    f = block_fields(packed, ggml_type)
    q = f.q.astype(np.int32)
    if GGMLType(ggml_type) in (GGMLType.Q5_0, GGMLType.Q5_1):
        bins = q >> 1
    elif GGMLType(ggml_type) == GGMLType.Q8_0:
        bins = (q + 128) >> 4
    else:
        bins = q
    hist = np.bincount(bins.reshape(-1), minlength=16)[:16]
    return packed, hist
