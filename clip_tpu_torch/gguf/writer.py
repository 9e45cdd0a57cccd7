"""GGUF writer: produce checkpoint files readable by this engine *and* by the
reference C++ implementation.

Functionally replaces the ``gguf_init_empty / gguf_set_kv / gguf_add_tensor /
gguf_set_tensor_data`` writer surface used by the reference quantizer
(upstream clip.cpp:1690-1820) and the ``gguf.GGUFWriter`` Python package
used by its converter (upstream models/convert_hf_to_gguf.py:126).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from .constants import (
    KEY_ALIGNMENT,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
)
from .reader import ggml_nbytes

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_TO_GGML = {
    np.dtype(np.float32): GGMLType.F32,
    np.dtype(np.float16): GGMLType.F16,
    np.dtype(np.int8): GGMLType.I8,
    np.dtype(np.int16): GGMLType.I16,
    np.dtype(np.int32): GGMLType.I32,
}


@dataclass
class _PendingTensor:
    name: str
    shape_gguf: tuple[int, ...]
    ggml_type: GGMLType
    data: bytes
    offset: int


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pack_value(vtype: GGUFValueType, value: Any) -> bytes:
    if vtype == GGUFValueType.BOOL:
        return struct.pack("<B", 1 if value else 0)
    if vtype == GGUFValueType.STRING:
        return _pack_string(value)
    if vtype == GGUFValueType.ARRAY:
        elem_type, items = value
        out = [struct.pack("<IQ", int(elem_type), len(items))]
        for it in items:
            out.append(_pack_value(elem_type, it))
        return b"".join(out)
    return struct.pack(_SCALAR_FMT[vtype], value)


class GGUFWriter:
    """Streaming GGUF v3 writer.

    KVs and tensor descriptors are buffered; tensor payloads are written
    aligned.  Call :meth:`write` to produce the file.
    """

    def __init__(self, path: str, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = str(path)
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        self._tensors: list[_PendingTensor] = []
        self._data_size = 0

    # -- KV helpers ---------------------------------------------------------

    def add_kv(self, key: str, vtype: GGUFValueType, value: Any) -> None:
        self._kv.append((key, vtype, value))

    def add_bool(self, key: str, value: bool) -> None:
        self.add_kv(key, GGUFValueType.BOOL, bool(value))

    def add_uint32(self, key: str, value: int) -> None:
        self.add_kv(key, GGUFValueType.UINT32, int(value))

    def add_int32(self, key: str, value: int) -> None:
        self.add_kv(key, GGUFValueType.INT32, int(value))

    def add_float32(self, key: str, value: float) -> None:
        self.add_kv(key, GGUFValueType.FLOAT32, float(value))

    def add_string(self, key: str, value: str) -> None:
        self.add_kv(key, GGUFValueType.STRING, str(value))

    def add_array_str(self, key: str, values: Sequence[str]) -> None:
        self.add_kv(key, GGUFValueType.ARRAY, (GGUFValueType.STRING, list(values)))

    def add_array_f32(self, key: str, values: Sequence[float]) -> None:
        self.add_kv(
            key, GGUFValueType.ARRAY, (GGUFValueType.FLOAT32, [float(v) for v in values])
        )

    def copy_kv_from(self, reader, skip: Sequence[str] = ()) -> None:
        """Copy all KVs from a GGUFReader (quantizer path: gguf_set_kv
        semantics, upstream clip.cpp:1691)."""
        for key in reader.kv:
            if key in skip:
                continue
            vtype = reader.kv_types[key]
            val = reader.kv[key]
            if vtype == GGUFValueType.ARRAY:
                if isinstance(val, list) and (not val or isinstance(val[0], str)):
                    self.add_array_str(key, val)
                elif isinstance(val, np.ndarray):
                    elem = {
                        np.dtype(np.float32): GGUFValueType.FLOAT32,
                        np.dtype(np.int32): GGUFValueType.INT32,
                        np.dtype(np.uint32): GGUFValueType.UINT32,
                        np.dtype(np.int64): GGUFValueType.INT64,
                        np.dtype(np.uint64): GGUFValueType.UINT64,
                        np.dtype(np.float64): GGUFValueType.FLOAT64,
                    }[val.dtype]
                    self.add_kv(key, vtype, (elem, val.tolist()))
                else:
                    self.add_array_str(key, [str(v) for v in val])
            else:
                self.add_kv(key, vtype, val)

    # -- tensors ------------------------------------------------------------

    def _align(self, n: int) -> int:
        return (n + self.alignment - 1) // self.alignment * self.alignment

    def add_tensor(self, name: str, data: np.ndarray) -> None:
        """Add an f32/f16/int tensor.  ``data`` uses numpy (row-major) shape;
        GGUF dims are stored reversed (ne[0] = contiguous)."""
        data = np.ascontiguousarray(data)
        ggml_type = _NP_TO_GGML[data.dtype]
        self.add_raw_tensor(
            name, tuple(reversed(data.shape)), ggml_type, data.tobytes()
        )

    def add_quantized_tensor(
        self,
        name: str,
        shape: tuple[int, ...],
        ggml_type: GGMLType,
        packed: np.ndarray,
    ) -> None:
        """Add a block-quantized tensor.  ``shape`` is the numpy (row-major)
        logical shape; ``packed`` the uint8 block buffer."""
        self.add_raw_tensor(
            name, tuple(reversed(shape)), ggml_type, np.ascontiguousarray(packed).tobytes()
        )

    def add_raw_tensor(
        self,
        name: str,
        shape_gguf: tuple[int, ...],
        ggml_type: GGMLType,
        data: bytes,
    ) -> None:
        expected = ggml_nbytes(shape_gguf, ggml_type)
        if len(data) != expected:
            raise ValueError(
                f"{name}: payload is {len(data)} bytes, expected {expected} for "
                f"{GGMLType(ggml_type).name} {shape_gguf}"
            )
        offset = self._align(self._data_size)
        self._tensors.append(
            _PendingTensor(name, tuple(int(d) for d in shape_gguf), ggml_type, data, offset)
        )
        self._data_size = offset + len(data)

    # -- output -------------------------------------------------------------

    def write(self) -> str:
        # a non-default alignment must be recorded in the file or readers
        # will compute wrong tensor offsets (silent corruption)
        if self.alignment != GGUF_DEFAULT_ALIGNMENT and not any(
            k == KEY_ALIGNMENT for k, _, _ in self._kv
        ):
            self.add_uint32(KEY_ALIGNMENT, self.alignment)
        header = [
            GGUF_MAGIC,
            struct.pack("<IQQ", GGUF_VERSION, len(self._tensors), len(self._kv)),
        ]
        for key, vtype, value in self._kv:
            header.append(_pack_string(key))
            header.append(struct.pack("<I", int(vtype)))
            header.append(_pack_value(vtype, value))
        for t in self._tensors:
            header.append(_pack_string(t.name))
            header.append(struct.pack("<I", len(t.shape_gguf)))
            for d in t.shape_gguf:
                header.append(struct.pack("<Q", d))
            header.append(struct.pack("<IQ", int(t.ggml_type), t.offset))
        meta = b"".join(header)
        pad = -len(meta) % self.alignment

        with open(self.path, "wb") as f:
            f.write(meta)
            f.write(b"\x00" * pad)
            pos = 0
            for t in self._tensors:
                f.write(b"\x00" * (t.offset - pos))
                f.write(t.data)
                pos = t.offset + len(t.data)
        return self.path
