"""GGUF checkpoint assembly: the ``write_clip_gguf`` half of the JAX
package's HF converter, which the synthetic-checkpoint factory needs.  The HF
state-dict conversion itself is not part of this package yet."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from .gguf import GGUFWriter
from .gguf import constants as C


def write_clip_gguf(
    path: str,
    tensors: Mapping[str, np.ndarray],
    *,
    text_config: Mapping | None,
    vision_config: Mapping | None,
    tokens: Sequence[str] | None,
    projection_dim: int,
    use_gelu: bool,
    image_mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073),
    image_std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711),
    name: str = "",
    ftype: int = 1,
    extra_quantized: Mapping[str, tuple] | None = None,
) -> str:
    """Assemble and write a clip.cpp-compatible GGUF checkpoint.

    ``extra_quantized`` maps tensor name -> (shape, GGMLType, packed blocks)
    for pre-quantized payloads (used by the synthetic-checkpoint factory).
    """
    w = GGUFWriter(path)
    has_text = text_config is not None
    has_vision = vision_config is not None
    w.add_bool(C.KEY_HAS_TEXT_ENC, has_text)
    w.add_bool(C.KEY_HAS_VIS_ENC, has_vision)
    w.add_uint32(C.KEY_FTYPE, ftype)
    if name:
        w.add_string(C.KEY_NAME, name)
    if has_text and has_vision:
        desc = "two-tower CLIP model"
    elif has_text:
        desc = "text-only CLIP model"
    else:
        desc = "vision-only CLIP model"
    w.add_string(C.KEY_DESCRIPTION, desc)

    if has_text:
        tc = text_config
        w.add_uint32(C.KEY_N_POSITIONS, tc["max_position_embeddings"])
        w.add_uint32(C.KEY_N_EMBD.format(tower="text"), tc["hidden_size"])
        w.add_uint32(C.KEY_N_FF.format(tower="text"), tc["intermediate_size"])
        w.add_uint32(C.KEY_PROJ_DIM.format(tower="text"), tc.get("projection_dim", projection_dim))
        w.add_uint32(C.KEY_N_HEAD.format(tower="text"), tc["num_attention_heads"])
        w.add_float32(C.KEY_LAYER_NORM_EPS.format(tower="text"), tc["layer_norm_eps"])
        w.add_uint32(C.KEY_N_BLOCK.format(tower="text"), tc["num_hidden_layers"])
        if tokens is None:
            raise ValueError("tokens list required for a text tower")
        w.add_array_str(C.KEY_TOKENS, tokens)

    if has_vision:
        vc = vision_config
        w.add_uint32(C.KEY_IMAGE_SIZE, vc["image_size"])
        w.add_uint32(C.KEY_PATCH_SIZE, vc["patch_size"])
        w.add_uint32(C.KEY_N_EMBD.format(tower="vision"), vc["hidden_size"])
        w.add_uint32(C.KEY_N_FF.format(tower="vision"), vc["intermediate_size"])
        w.add_uint32(C.KEY_PROJ_DIM.format(tower="vision"), vc.get("projection_dim", projection_dim))
        w.add_uint32(C.KEY_N_HEAD.format(tower="vision"), vc["num_attention_heads"])
        w.add_float32(C.KEY_LAYER_NORM_EPS.format(tower="vision"), vc["layer_norm_eps"])
        w.add_uint32(C.KEY_N_BLOCK.format(tower="vision"), vc["num_hidden_layers"])
        w.add_array_f32(C.KEY_IMAGE_MEAN, image_mean)
        w.add_array_f32(C.KEY_IMAGE_STD, image_std)

    w.add_bool(C.KEY_USE_GELU, use_gelu)

    for tname, data in tensors.items():
        w.add_tensor(tname, data)
    for tname, (shape, qtype, packed) in (extra_quantized or {}).items():
        w.add_quantized_tensor(tname, shape, qtype, packed)
    return w.write()
