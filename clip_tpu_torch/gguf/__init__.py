from . import constants
from .constants import GGMLType, GGUFValueType
from .reader import GGUFReader, TensorInfo, ggml_nbytes
from .writer import GGUFWriter

__all__ = [
    "constants",
    "GGMLType",
    "GGUFValueType",
    "GGUFReader",
    "GGUFWriter",
    "TensorInfo",
    "ggml_nbytes",
]
