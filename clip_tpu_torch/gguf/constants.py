"""GGUF container-format and ggml-type constants.

The GGUF container holds typed key/value metadata plus an aligned blob of named
tensors.  This module defines the enums and the CLIP-specific metadata keys /
tensor-name templates consumed by the engine (reference: upstream clip.cpp:41-79
defines the same key strings; upstream models/convert_hf_to_gguf.py writes them).
"""

from __future__ import annotations

import enum

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    """Wire types for GGUF key/value metadata entries."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """ggml tensor storage types (subset used by CLIP checkpoints).

    Numbering follows the ggml enum so that files are interchangeable with the
    reference implementation (see ftype handling at upstream clip.cpp:117-143).
    """

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2 / Q4_3, removed upstream.
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    I8 = 16
    I16 = 17
    I32 = 18


#: Block size (elements) shared by every block-quantized ggml type we support.
QK = 32

#: (block_nbytes, elements_per_block) for each storage type. F32/F16 use
#: (elsize, 1).
GGML_TYPE_SIZES = {
    GGMLType.F32: (4, 1),
    GGMLType.F16: (2, 1),
    GGMLType.Q4_0: (2 + QK // 2, QK),          # fp16 d + 16B nibbles
    GGMLType.Q4_1: (2 + 2 + QK // 2, QK),      # fp16 d, fp16 m + nibbles
    GGMLType.Q5_0: (2 + 4 + QK // 2, QK),      # fp16 d, u32 high bits + nibbles
    GGMLType.Q5_1: (2 + 2 + 4 + QK // 2, QK),  # fp16 d, fp16 m, u32 qh + nibbles
    GGMLType.Q8_0: (2 + QK, QK),               # fp16 d + 32 int8
    GGMLType.I8: (1, 1),
    GGMLType.I16: (2, 1),
    GGMLType.I32: (4, 1),
}

#: "general.file_type" values used by clip.cpp checkpoints
#: (upstream clip.cpp:117-143): the itype CLI argument of the quantizer
#: uses the same numbering (upstream clip.cpp:1661-1684).
FTYPE_TO_NAME = {
    0: "f32",
    1: "f16",
    2: "q4_0",
    3: "q4_1",
    6: "q5_0",
    7: "q5_1",
    8: "q8_0",
}

NAME_TO_FTYPE = {v: k for k, v in FTYPE_TO_NAME.items()}

FTYPE_TO_GGML = {
    0: GGMLType.F32,
    1: GGMLType.F16,
    2: GGMLType.Q4_0,
    3: GGMLType.Q4_1,
    6: GGMLType.Q5_0,
    7: GGMLType.Q5_1,
    8: GGMLType.Q8_0,
}

GGML_TO_FTYPE = {v: k for k, v in FTYPE_TO_GGML.items()}

# ---------------------------------------------------------------------------
# CLIP metadata keys (match upstream clip.cpp:41-58)
# ---------------------------------------------------------------------------

KEY_FTYPE = "general.file_type"
KEY_NAME = "general.name"
KEY_DESCRIPTION = "general.description"
KEY_QNT_VERSION = "general.quantization_version"
KEY_ALIGNMENT = "general.alignment"
KEY_ARCHITECTURE = "general.architecture"
KEY_HAS_TEXT_ENC = "clip.has_text_encoder"
KEY_HAS_VIS_ENC = "clip.has_vision_encoder"
KEY_USE_GELU = "clip.use_gelu"
KEY_N_EMBD = "clip.{tower}.embedding_length"
KEY_N_FF = "clip.{tower}.feed_forward_length"
KEY_N_BLOCK = "clip.{tower}.block_count"
KEY_N_HEAD = "clip.{tower}.attention.head_count"
KEY_LAYER_NORM_EPS = "clip.{tower}.attention.layer_norm_epsilon"
KEY_PROJ_DIM = "clip.{tower}.projection_dim"
KEY_TOKENS = "tokenizer.ggml.tokens"
KEY_N_POSITIONS = "clip.text.context_length"
KEY_IMAGE_SIZE = "clip.vision.image_size"
KEY_PATCH_SIZE = "clip.vision.patch_size"
KEY_IMAGE_MEAN = "clip.vision.image_mean"
KEY_IMAGE_STD = "clip.vision.image_std"

GGML_QNT_VERSION = 2

# ---------------------------------------------------------------------------
# CLIP tensor-name templates (match upstream clip.cpp:64-79).
# {t} is "t" for the text tower and "v" for the vision tower; {i} the layer
# index; {w} "weight" or "bias".
# ---------------------------------------------------------------------------

TN_TOKEN_EMBD = "{t}.token_embd.weight"
TN_POS_EMBD = "{t}.position_embd.weight"
TN_CLASS_EMBD = "v.class_embd"
TN_PATCH_EMBD = "v.patch_embd.weight"
TN_ATTN_K = "{t}.blk.{i}.attn_k.{w}"
TN_ATTN_Q = "{t}.blk.{i}.attn_q.{w}"
TN_ATTN_V = "{t}.blk.{i}.attn_v.{w}"
TN_ATTN_OUTPUT = "{t}.blk.{i}.attn_out.{w}"
# NOTE: the GGUF names are historically swapped relative to their function:
# "ffn_down" holds HF mlp.fc1 (hidden -> intermediate, i.e. the UP projection)
# and "ffn_up" holds HF mlp.fc2 (intermediate -> hidden).  See the rename table
# in upstream models/convert_hf_to_gguf.py:35 and usage at
# upstream clip.cpp:1127-1137 (ff_i_w = ffn_down applied first).
TN_FFN_DOWN = "{t}.blk.{i}.ffn_down.{w}"
TN_FFN_UP = "{t}.blk.{i}.ffn_up.{w}"
TN_LN_1 = "{t}.blk.{i}.ln1.{w}"
TN_LN_2 = "{t}.blk.{i}.ln2.{w}"
TN_LN_PRE = "{t}.pre_ln.{w}"
TN_LN_POST = "{t}.post_ln.{w}"
TN_TEXT_PROJ = "text_projection.weight"
TN_VIS_PROJ = "visual_projection.weight"
