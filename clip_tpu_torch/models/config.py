"""Model configuration parsed from GGUF metadata.

Mirrors the hparam structs of the reference (upstream clip.h:14-34) and
the KV keys read by its loader (upstream clip.cpp:464-542).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..gguf import constants as C


@dataclass(frozen=True)
class TextConfig:
    n_vocab: int
    num_positions: int
    hidden_size: int
    n_intermediate: int
    projection_dim: int
    n_head: int
    n_layer: int
    eps: float

    @property
    def d_head(self) -> int:
        return self.hidden_size // self.n_head


@dataclass(frozen=True)
class VisionConfig:
    image_size: int
    patch_size: int
    hidden_size: int
    n_intermediate: int
    projection_dim: int
    n_head: int
    n_layer: int
    eps: float

    @property
    def d_head(self) -> int:
        return self.hidden_size // self.n_head

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1


@dataclass(frozen=True)
class ClipConfig:
    has_text: bool
    has_vision: bool
    use_gelu: bool                      # True: tanh-gelu; False: quick-gelu
    ftype: int
    text: TextConfig | None = None
    vision: VisionConfig | None = None
    image_mean: tuple[float, float, float] = (0.0, 0.0, 0.0)
    image_std: tuple[float, float, float] = (1.0, 1.0, 1.0)
    name: str = ""
    description: str = ""

    @staticmethod
    def from_gguf(reader) -> "ClipConfig":
        kv = reader.kv

        def tower_key(tmpl: str, tower: str) -> str:
            return tmpl.format(tower=tower)

        has_text = bool(kv[C.KEY_HAS_TEXT_ENC])
        has_vision = bool(kv[C.KEY_HAS_VIS_ENC])

        text = None
        if has_text:
            text = TextConfig(
                n_vocab=len(kv[C.KEY_TOKENS]),
                num_positions=int(kv[C.KEY_N_POSITIONS]),
                hidden_size=int(kv[tower_key(C.KEY_N_EMBD, "text")]),
                n_intermediate=int(kv[tower_key(C.KEY_N_FF, "text")]),
                projection_dim=int(kv[tower_key(C.KEY_PROJ_DIM, "text")]),
                n_head=int(kv[tower_key(C.KEY_N_HEAD, "text")]),
                n_layer=int(kv[tower_key(C.KEY_N_BLOCK, "text")]),
                eps=float(kv[tower_key(C.KEY_LAYER_NORM_EPS, "text")]),
            )

        vision = None
        mean = (0.0, 0.0, 0.0)
        std = (1.0, 1.0, 1.0)
        if has_vision:
            vision = VisionConfig(
                image_size=int(kv[C.KEY_IMAGE_SIZE]),
                patch_size=int(kv[C.KEY_PATCH_SIZE]),
                hidden_size=int(kv[tower_key(C.KEY_N_EMBD, "vision")]),
                n_intermediate=int(kv[tower_key(C.KEY_N_FF, "vision")]),
                projection_dim=int(kv[tower_key(C.KEY_PROJ_DIM, "vision")]),
                n_head=int(kv[tower_key(C.KEY_N_HEAD, "vision")]),
                n_layer=int(kv[tower_key(C.KEY_N_BLOCK, "vision")]),
                eps=float(kv[tower_key(C.KEY_LAYER_NORM_EPS, "vision")]),
            )
            mean = tuple(np.asarray(kv[C.KEY_IMAGE_MEAN], dtype=np.float32).tolist())
            std = tuple(np.asarray(kv[C.KEY_IMAGE_STD], dtype=np.float32).tolist())

        return ClipConfig(
            has_text=has_text,
            has_vision=has_vision,
            use_gelu=bool(kv[C.KEY_USE_GELU]),
            ftype=int(kv.get(C.KEY_FTYPE, 1)),
            text=text,
            vision=vision,
            image_mean=mean,
            image_std=std,
            name=str(kv.get(C.KEY_NAME, "")),
            description=str(kv.get(C.KEY_DESCRIPTION, "")),
        )
