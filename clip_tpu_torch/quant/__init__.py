from .formats import (
    QK,
    QUANT_TYPES,
    BlockFields,
    block_fields,
    dequantize,
    quantize,
    quantize_with_hist,
)

__all__ = [
    "QK",
    "QUANT_TYPES",
    "BlockFields",
    "block_fields",
    "dequantize",
    "quantize",
    "quantize_with_hist",
]
