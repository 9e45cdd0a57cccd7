"""GGUF reader: parse metadata and mmap tensor blobs with zero copies.

Functionally replaces the ``gguf_*`` read API consumed by the reference
(`upstream clip.cpp:334-461` does a metadata pass followed by per-tensor
seek+fread).  Here the file is memory-mapped once and each tensor is exposed as
a numpy view into the map, so loading is O(metadata) and tensor bytes are paged
in lazily by the OS.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGML_TYPE_SIZES,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    KEY_ALIGNMENT,
)

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

_SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


def ggml_nbytes(shape: tuple[int, ...], ggml_type: GGMLType) -> int:
    """Byte size of a tensor stored in the given ggml type.

    Block quantization applies along the innermost (fastest-varying) GGUF
    dimension; that dimension must be a multiple of the block size.
    """
    block_bytes, block_elems = GGML_TYPE_SIZES[GGMLType(ggml_type)]
    n = 1
    for d in shape:
        n *= int(d)
    if block_elems == 1:
        return n * block_bytes
    if shape and shape[0] % block_elems != 0:
        raise ValueError(
            f"innermost dim {shape[0]} not a multiple of block size {block_elems}"
        )
    return n // block_elems * block_bytes


@dataclass
class TensorInfo:
    """Descriptor for one tensor in a GGUF file.

    ``shape_gguf`` is the on-disk dimension order (ne[0] first = contiguous,
    ggml convention).  ``shape`` is the numpy/row-major order (reversed), which
    is what the rest of the framework uses.
    """

    name: str
    shape_gguf: tuple[int, ...]
    ggml_type: GGMLType
    offset: int  # relative to data section start
    nbytes: int = field(init=False)

    def __post_init__(self) -> None:
        self.nbytes = ggml_nbytes(self.shape_gguf, self.ggml_type)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(reversed(self.shape_gguf))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape_gguf:
            n *= d
        return n


class GGUFReader:
    """Parse a GGUF file; expose KV metadata and mmap'd tensor data.

    Usage::

        r = GGUFReader(path)
        r.kv["clip.use_gelu"]
        arr = r.tensor_data("t.token_embd.weight")   # raw bytes view
        f = r.tensor_as_float("t.token_embd.weight") # dequantized float32
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.kv: dict[str, Any] = {}
        self.kv_types: dict[str, GGUFValueType] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._f: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        try:
            self._parse()
        except (struct.error, IndexError, UnicodeDecodeError) as e:
            raise ValueError(
                f"{self.path}: truncated or corrupt GGUF "
                f"(parse failed at byte {self._pos}: {e})") from e

    # -- low-level readers --------------------------------------------------

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self._mm, self._pos)
        self._pos += size
        return vals[0] if len(vals) == 1 else vals

    def _read_len(self) -> int:
        """Lengths/counts (string lengths, array counts, tensor/kv counts,
        tensor dims) are uint32 in GGUF v1, uint64 from v2 on — the entire
        v1->v2 format change (the era of the published mys/ggml_clip-*
        checkpoints the reference's bindings auto-download,
        upstream examples/python_bindings/clip_cpp/clip.py:260-309)."""
        return self._read("<I" if self.version == 1 else "<Q")

    def _read_string(self) -> str:
        n = self._read_len()
        s = self._mm[self._pos : self._pos + n]
        self._pos += n
        return s.decode("utf-8")

    def _read_value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.BOOL:
            return bool(self._read("<B"))
        if vtype == GGUFValueType.STRING:
            return self._read_string()
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self._read("<I"))
            count = self._read_len()
            if elem_type == GGUFValueType.STRING:
                return [self._read_string() for _ in range(count)]
            if elem_type == GGUFValueType.ARRAY:
                return [self._read_value(GGUFValueType.ARRAY) for _ in range(count)]
            if elem_type == GGUFValueType.BOOL:
                arr = np.frombuffer(self._mm, np.uint8, count, self._pos).astype(bool)
                self._pos += count
                return arr
            dt = _SCALAR_NP[elem_type]
            arr = np.frombuffer(self._mm, dt, count, self._pos)
            self._pos += arr.nbytes
            return arr
        return self._read(_SCALAR_FMT[vtype])

    # -- parsing ------------------------------------------------------------

    def _parse(self) -> None:
        magic = self._mm[0:4]
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic={magic!r})")
        self._pos = 4
        self.version = self._read("<I")
        if self.version < 1 or self.version > 3:
            raise ValueError(
                f"GGUF v{self.version} is not supported (v1-v3; the reference "
                f"prints the version and trusts its ggml snapshot, clip.cpp:359)")
        n_tensors = self._read_len()
        n_kv = self._read_len()

        for _ in range(n_kv):
            key = self._read_string()
            vtype = GGUFValueType(self._read("<I"))
            self.kv[key] = self._read_value(vtype)
            self.kv_types[key] = vtype

        order: list[TensorInfo] = []
        for _ in range(n_tensors):
            name = self._read_string()
            n_dims = self._read("<I")
            shape_gguf = tuple(self._read_len() for _ in range(n_dims))
            ggml_type = GGMLType(self._read("<I"))
            offset = self._read("<Q")
            info = TensorInfo(name, shape_gguf, ggml_type, offset)
            self.tensors[name] = info
            order.append(info)
        self.tensor_order = order

        self.alignment = int(self.kv.get(KEY_ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))
        pad = -self._pos % self.alignment
        self.data_offset = self._pos + pad

        # every tensor's blob must lie inside the file — catches truncation
        # that leaves the (small, front-loaded) metadata intact
        fsize = len(self._mm)
        for info in order:
            end = self.data_offset + info.offset + info.nbytes
            if end > fsize:
                raise ValueError(
                    f"{self.path}: truncated or corrupt GGUF (tensor "
                    f"{info.name!r} extends to byte {end} of a {fsize}-byte "
                    f"file)")

    # -- tensor access ------------------------------------------------------

    def tensor_bytes(self, name: str) -> memoryview:
        """Raw storage bytes of a tensor as a zero-copy view."""
        info = self.tensors[name]
        start = self.data_offset + info.offset
        return memoryview(self._mm)[start : start + info.nbytes]

    def tensor_data(self, name: str) -> np.ndarray:
        """Tensor in its native storage.

        f32/f16/int types return an ndarray with the numpy (reversed) shape;
        quantized types return the packed uint8 block buffer of shape
        ``(n_blocks, block_nbytes)``.
        """
        info = self.tensors[name]
        buf = self.tensor_bytes(name)
        t = info.ggml_type
        if t == GGMLType.F32:
            return np.frombuffer(buf, np.float32).reshape(info.shape)
        if t == GGMLType.F16:
            return np.frombuffer(buf, np.float16).reshape(info.shape)
        if t == GGMLType.I8:
            return np.frombuffer(buf, np.int8).reshape(info.shape)
        if t == GGMLType.I16:
            return np.frombuffer(buf, np.int16).reshape(info.shape)
        if t == GGMLType.I32:
            return np.frombuffer(buf, np.int32).reshape(info.shape)
        block_bytes, _ = GGML_TYPE_SIZES[t]
        raw = np.frombuffer(buf, np.uint8)
        return raw.reshape(-1, block_bytes)

    def tensor_as_float(self, name: str) -> np.ndarray:
        """Tensor dequantized to float32 with the numpy (reversed) shape."""
        from ..quant import dequantize  # local import to avoid cycle

        info = self.tensors[name]
        t = info.ggml_type
        if t in (GGMLType.F32, GGMLType.F16):
            return np.ascontiguousarray(self.tensor_data(name), dtype=np.float32)
        if t in (GGMLType.I8, GGMLType.I16, GGMLType.I32):
            return self.tensor_data(name).astype(np.float32)
        return dequantize(self.tensor_data(name), t).reshape(info.shape)

    def close(self) -> None:
        # Best-effort: numpy views handed out by tensor_data() keep the map
        # exported; in that case the mapping is released when they are GC'd.
        try:
            self._mm.close()
        except BufferError:
            pass
        self._f.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
