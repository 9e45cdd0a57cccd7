"""Synthetic GGUF checkpoint factory.

Real OpenAI/LAION weights are not shipped with the repository, so this
module fabricates GGUF checkpoints with the exact
shapes/metadata of the published model variants (hparams as hardcoded in the
reference's memory tables, upstream clip.cpp:261-331, and the HF
configs) with random weights — enough for benchmarking, compile checks, and
integration tests.  Real checkpoints converted by the JAX package's converter
(or by clip.cpp itself) load through the identical code path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .convert import write_clip_gguf
from .gguf.constants import NAME_TO_FTYPE, FTYPE_TO_GGML
from .quant import quantize as quantize_blocks

N_VOCAB = 49408


@dataclass(frozen=True)
class Variant:
    # text tower
    t_hidden: int
    t_heads: int
    t_layers: int
    t_ff: int
    # vision tower
    v_hidden: int
    v_heads: int
    v_layers: int
    v_ff: int
    image_size: int
    patch_size: int
    projection_dim: int
    n_positions: int = 77


VARIANTS = {
    "ViT-B/32": Variant(512, 8, 12, 2048, 768, 12, 12, 3072, 224, 32, 512),
    "ViT-B/16": Variant(512, 8, 12, 2048, 768, 12, 12, 3072, 224, 16, 512),
    "ViT-L/14": Variant(768, 12, 12, 3072, 1024, 16, 24, 4096, 224, 14, 768),
    "ViT-L/14-336": Variant(768, 12, 12, 3072, 1024, 16, 24, 4096, 336, 14, 768),
    "ViT-H/14": Variant(1024, 16, 24, 4096, 1280, 16, 32, 5120, 224, 14, 1024),
}


def synthetic_vocab() -> list[str]:
    """49408 tokens with CLIP's special tokens in the standard positions."""
    toks = [f"w{i}</w>" if i % 2 == 0 else f"s{i}" for i in range(N_VOCAB)]
    # seed some real-ish words for tokenizer exercises
    for i, word in enumerate(["a</w>", "an</w>", "apple</w>", "photo</w>", "of</w>",
                              "red</w>", "white</w>", "cat</w>", "dog</w>", "the</w>"]):
        toks[1000 + i] = word
    toks[49406] = "<|startoftext|>"
    toks[49407] = "<|endoftext|>"
    return toks


def make_synthetic_gguf(
    path: str,
    variant: str = "ViT-B/32",
    *,
    ftype: str = "f16",
    towers: str = "both",
    seed: int = 0,
    use_gelu: bool = False,
) -> str:
    """Write a random checkpoint.  ``ftype``: f32/f16/q4_0/q4_1/q5_0/q5_1/q8_0
    (quantized types quantize every 2-D weight, like the model quantizer)."""
    v = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    if ftype not in NAME_TO_FTYPE:
        raise ValueError(f"unknown ftype {ftype!r}")
    ftype_id = NAME_TO_FTYPE[ftype]
    quant_type = FTYPE_TO_GGML[ftype_id] if ftype_id >= 2 else None

    tensors: dict[str, np.ndarray] = {}
    qtensors: dict[str, tuple] = {}  # name -> (shape, qtype, packed)

    def w2(name: str, out_d: int, in_d: int, scale: float = 0.02) -> None:
        data = rng.normal(0, scale, (out_d, in_d)).astype(np.float32)
        if quant_type is not None and in_d % 32 == 0:
            qtensors[name] = ((out_d, in_d), quant_type, quantize_blocks(data, quant_type))
        elif ftype_id == 0:
            tensors[name] = data
        else:
            tensors[name] = data.astype(np.float16)

    def vec(name: str, n: int, fill: float | None = None) -> None:
        if fill is not None:
            tensors[name] = np.full(n, fill, np.float32)
        else:
            tensors[name] = rng.normal(0, 0.02, n).astype(np.float32)

    has_text = towers in ("both", "text")
    has_vision = towers in ("both", "vision")

    def tower(prefix: str, hidden: int, layers: int, ff: int) -> None:
        for i in range(layers):
            base = f"{prefix}.blk.{i}"
            for nm in ("attn_q", "attn_k", "attn_v", "attn_out"):
                w2(f"{base}.{nm}.weight", hidden, hidden)
                vec(f"{base}.{nm}.bias", hidden)
            w2(f"{base}.ffn_down.weight", ff, hidden)   # fc1 / up-proj
            vec(f"{base}.ffn_down.bias", ff)
            w2(f"{base}.ffn_up.weight", hidden, ff)     # fc2 / down-proj
            vec(f"{base}.ffn_up.bias", hidden)
            for ln in ("ln1", "ln2"):
                vec(f"{base}.{ln}.weight", hidden, fill=1.0)
                vec(f"{base}.{ln}.bias", hidden, fill=0.0)

    if has_text:
        w2("t.token_embd.weight", N_VOCAB, v.t_hidden)
        w2("t.position_embd.weight", v.n_positions, v.t_hidden)
        tower("t", v.t_hidden, v.t_layers, v.t_ff)
        vec("t.post_ln.weight", v.t_hidden, fill=1.0)
        vec("t.post_ln.bias", v.t_hidden, fill=0.0)
        w2("text_projection.weight", v.projection_dim, v.t_hidden)

    if has_vision:
        n_patches = (v.image_size // v.patch_size) ** 2
        vec("v.class_embd", v.v_hidden)
        # conv patch embed is always f16 (reference converter behavior)
        tensors["v.patch_embd.weight"] = rng.normal(
            0, 0.02, (v.v_hidden, 3, v.patch_size, v.patch_size)
        ).astype(np.float16)
        w2("v.position_embd.weight", n_patches + 1, v.v_hidden)
        vec("v.pre_ln.weight", v.v_hidden, fill=1.0)
        vec("v.pre_ln.bias", v.v_hidden, fill=0.0)
        tower("v", v.v_hidden, v.v_layers, v.v_ff)
        vec("v.post_ln.weight", v.v_hidden, fill=1.0)
        vec("v.post_ln.bias", v.v_hidden, fill=0.0)
        w2("visual_projection.weight", v.projection_dim, v.v_hidden)

    text_config = None
    if has_text:
        text_config = dict(
            max_position_embeddings=v.n_positions,
            hidden_size=v.t_hidden,
            intermediate_size=v.t_ff,
            projection_dim=v.projection_dim,
            num_attention_heads=v.t_heads,
            layer_norm_eps=1e-5,
            num_hidden_layers=v.t_layers,
        )
    vision_config = None
    if has_vision:
        vision_config = dict(
            image_size=v.image_size,
            patch_size=v.patch_size,
            hidden_size=v.v_hidden,
            intermediate_size=v.v_ff,
            projection_dim=v.projection_dim,
            num_attention_heads=v.v_heads,
            layer_norm_eps=1e-5,
            num_hidden_layers=v.v_layers,
        )

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    out = write_clip_gguf(
        path,
        tensors,
        text_config=text_config,
        vision_config=vision_config,
        tokens=synthetic_vocab() if has_text else None,
        projection_dim=v.projection_dim,
        use_gelu=use_gelu,
        name=f"synthetic {variant}",
        ftype=ftype_id,
        extra_quantized=qtensors,
    )
    return out
