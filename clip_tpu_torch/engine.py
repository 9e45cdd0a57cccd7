"""ClipEngine: the user-facing inference engine of the PyTorch port.

The public API of the JAX package's ``engine.py`` (load, tokenize,
preprocess, text and image encode, compare, similarity, softmax with
sorting, zero-shot labeling) over the port's towers.  It runs on CUDA by
default (``device="cuda:0"``) and raises if no card is present; pass
``device="cpu"`` for the plain PyTorch versions on the CPU.

As in the JAX engine, batches are padded up to power-of-two buckets, text is
padded to the model's full context, and a quantized checkpoint's layer
weights are re-quantized to per-channel int8 at load, keeping their packed
source (the W8A8 route); an f16 or f32 checkpoint keeps its layer weights
dense in the compute dtype (the dense route).  ``route`` says which one a
checkpoint took.  On the W8A8 route the engine passes the JAX engine's TPU
flags to the towers: ``lnq_fuse`` (default on) and, where it is off, the
``up_gq`` MLP.  A batch of uint8 images of one shape is preprocessed on the
device by default (``ops.device_preprocess``), as the JAX engine does.
"""

from __future__ import annotations

import numbers
import sys
from typing import Sequence

import numpy as np
import torch

from .gguf import GGUFReader
from .gguf import constants as C
from .models.config import ClipConfig
from .models.params import load_params
from .models.transformer import route
from .models.text import encode_text
from .models.vision import encode_image
from .ops.device_preprocess import make_device_preprocess
from .preprocess import load_image, preprocess_batch
from .tokenizer import ClipTokenizer

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + _BUCKETS[-1] - 1) // _BUCKETS[-1]) * _BUCKETS[-1]


def softmax_with_sorting(scores: Sequence[float]) -> tuple[np.ndarray, np.ndarray]:
    """Softmax (with the reference's +1e-9 regularizer) then sort descending.
    Returns (sorted_probs, original_indices)."""
    arr = np.asarray(scores, dtype=np.float64)
    e = np.exp(arr) + 1e-9
    probs = e / e.sum()
    order = np.argsort(-probs, kind="stable")
    return probs[order].astype(np.float32), order.astype(np.int32)


def similarity_score(v1: np.ndarray, v2: np.ndarray) -> float:
    """Plain dot product."""
    return float(np.dot(np.asarray(v1, np.float32), np.asarray(v2, np.float32)))


def _log(verbosity: int, level: int, msg: str, *args) -> None:
    if verbosity >= level:
        print(msg % args if args else msg, file=sys.stderr)


class ClipEngine:
    """Load a GGUF CLIP checkpoint and serve text/image embeddings.

    ``kernels=False`` runs the plain PyTorch versions of the kernels on any
    device: the reference a card's kernels are held against.  On a card the
    kernels take bfloat16 (the default compute dtype there); the CPU
    defaults to float32.

    ``lnq_fuse`` (W8A8 route only): ``None`` takes the JAX engine's TPU
    default, on; ``False`` runs LN in the compute dtype ahead of the
    projections and, on a card, the ``up_gq`` MLP (``_upgq_active``, as
    ``clip_tpu/engine.py:279-288, 394-404``)."""

    def __init__(self, model_path: str, *, device: str | torch.device | None = None,
                 compute_dtype: str | None = None, kernels: bool = True,
                 lnq_fuse: bool | None = None, verbosity: int = 1):
        self.device = torch.device("cuda:0" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        if compute_dtype is None:
            compute_dtype = "float32" if self.device.type == "cpu" else "bfloat16"
        self.compute_dtype = getattr(torch, compute_dtype)
        if (kernels and self.device.type == "cuda"
                and self.compute_dtype != torch.bfloat16):
            raise ValueError("the CUDA kernels take bfloat16: use compute_dtype='bfloat16' "
                             "or kernels=False")
        self.kernels = kernels
        self.model_path = str(model_path)
        self.verbosity = verbosity
        self.reader = GGUFReader(self.model_path)
        self.config = ClipConfig.from_gguf(self.reader)
        ft = C.FTYPE_TO_NAME.get(self.config.ftype, "?")
        _log(verbosity, 1, "model: %s (%s) on %s", self.config.name or self.model_path, ft,
             self.device)
        self.params = load_params(self.reader, self.config, device=self.device,
                                  dtype=self.compute_dtype)
        routes = {route(self.params[t]["layers"]) for t in ("text", "vision")
                  if t in self.params}
        self.route = "/".join(sorted(routes))
        w8a8 = "w8a8" in routes
        self.lnq_fuse = w8a8 and (True if lnq_fuse is None else bool(lnq_fuse))
        self.up_gq = w8a8 and self.device.type == "cuda"
        _log(verbosity, 1, "route: %s, compute dtype %s, kernels %s, lnq_fuse %s, up_gq %s",
             self.route, compute_dtype, "on" if kernels else "off (plain versions)",
             self.lnq_fuse, self._upgq_active)
        self._prep_cache: dict = {}

        self.tokenizer: ClipTokenizer | None = None
        if self.config.has_text:
            tokens = self.reader.kv[C.KEY_TOKENS]
            # BOS/EOS are 49406/49407 in the CLIP vocab == n_vocab-2 / n_vocab-1;
            # derive from size so reduced-vocab checkpoints stay in range
            n = len(tokens)
            self.tokenizer = ClipTokenizer(tokens, bos_id=min(49406, n - 2),
                                           eos_id=min(49407, n - 1))

    @property
    def _upgq_active(self) -> bool:
        """The ``up_gq`` MLP runs only where the lnq producers are off."""
        return self.up_gq and not self.lnq_fuse

    def tower_flags(self) -> dict:
        """The W8A8 route flags the engine passes to both towers."""
        return dict(lnq_fuse=self.lnq_fuse, up_gq=self._upgq_active)

    @property
    def projection_dim(self) -> int:
        cfg = self.config.vision or self.config.text
        return cfg.projection_dim

    # -- tokenize / preprocess ----------------------------------------------

    def tokenize(self, text: str) -> list[int]:
        if self.tokenizer is None:
            raise RuntimeError("this checkpoint has no text encoder")
        return self.tokenizer.encode(text, max_len=self.config.text.num_positions)

    def load_image(self, path: str) -> np.ndarray:
        return load_image(path)

    def preprocess(self, images, n_workers: int = 4) -> np.ndarray:
        """uint8 RGB image(s) -> normalized float32 NHWC batch (host numpy)."""
        if self.config.vision is None:
            raise RuntimeError("this checkpoint has no vision encoder")
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        imgs = []
        for im in images:
            im = np.asarray(im)
            if im.ndim == 2:
                im = np.stack([im] * 3, axis=-1)
            if im.shape[-1] == 4:
                im = im[..., :3]
            imgs.append(im)
        return preprocess_batch(imgs, self.config.vision.image_size,
                                np.asarray(self.config.image_mean),
                                np.asarray(self.config.image_std), n_workers=n_workers)

    # -- encoding -------------------------------------------------------------

    def encode_text(self, texts, *, normalize: bool = True) -> np.ndarray:
        """Encode one string / token list or a batch of them.
        Returns [D] for a single input, [B, D] for a batch."""
        if self.tokenizer is None:
            raise RuntimeError("this checkpoint has no text encoder")
        single = isinstance(texts, str) or (
            isinstance(texts, (list, tuple)) and texts
            and isinstance(texts[0], numbers.Integral))
        if single:
            texts = [texts]
        if len(texts) > _BUCKETS[-1]:
            return np.concatenate([
                self.encode_text(list(texts[i:i + _BUCKETS[-1]]), normalize=normalize)
                for i in range(0, len(texts), _BUCKETS[-1])], axis=0)
        n_pos = self.config.text.num_positions
        ids_list = [self.tokenize(t) if isinstance(t, str) else list(t) for t in texts]
        b = len(ids_list)
        bb = _bucket(b)
        ids = np.full((bb, n_pos), self.tokenizer.eos_id, np.int64)
        lengths = np.ones(bb, np.int64)
        for i, t in enumerate(ids_list):
            ids[i], lengths[i] = self.tokenizer.pad(t, n_pos)
        with torch.inference_mode():
            out = encode_text(
                self.params["text"], self.config.text,
                torch.from_numpy(ids).to(self.device), torch.from_numpy(lengths).to(self.device),
                use_gelu=self.config.use_gelu, normalize=normalize,
                compute_dtype=self.compute_dtype, kernels=self.kernels, **self.tower_flags())
            out = out[:b].to(torch.float32).cpu().numpy()
        return out[0] if single else out

    def _encode_pixels(self, px: torch.Tensor, normalize: bool) -> torch.Tensor:
        return encode_image(self.params["vision"], self.config.vision,
                            px.to(self.compute_dtype), use_gelu=self.config.use_gelu,
                            normalize=normalize, compute_dtype=self.compute_dtype,
                            kernels=self.kernels, **self.tower_flags())

    def encode_image(self, images, *, normalize: bool = True,
                     preprocessed: bool | None = None,
                     device_preprocess: bool = True) -> np.ndarray:
        """Encode image(s): file path(s), uint8 arrays, or preprocessed float
        NHWC batches.  Returns [D] or [B, D].

        uint8 images that share one shape are preprocessed on the device,
        ahead of the encode (``device_preprocess=False`` forces the host
        bicubic), as the JAX engine does (``clip_tpu/engine.py:602-647``)."""
        if self.config.vision is None:
            raise RuntimeError("this checkpoint has no vision encoder")
        single = isinstance(images, (str, np.ndarray)) and (
            isinstance(images, str) or images.ndim == 3)
        if single:
            images = [images]
        n_in = images.shape[0] if isinstance(images, np.ndarray) else len(images)
        if n_in > _BUCKETS[-1]:
            return np.concatenate([
                self.encode_image(images[i:i + _BUCKETS[-1]], normalize=normalize,
                                  preprocessed=preprocessed,
                                  device_preprocess=device_preprocess)
                for i in range(0, n_in, _BUCKETS[-1])], axis=0)
        if isinstance(images, np.ndarray) and images.ndim == 4 and images.dtype != np.uint8:
            pixels = np.asarray(images, np.float32)
        else:
            arrs = [self.load_image(im) if isinstance(im, str) else im for im in images]
            if preprocessed or (arrs and arrs[0].dtype != np.uint8):
                pixels = np.stack([np.asarray(a, np.float32) for a in arrs])
            elif (device_preprocess and arrs
                  and all(a.ndim == 3 and a.shape == arrs[0].shape for a in arrs)):
                return self._encode_image_raw(np.stack(arrs), normalize=normalize,
                                              single=single)
            else:
                pixels = self.preprocess(arrs)
        b = pixels.shape[0]
        bb = _bucket(b)
        if bb != b:
            pixels = np.concatenate([pixels, np.repeat(pixels[-1:], bb - b, axis=0)], axis=0)
        with torch.inference_mode():
            px = torch.from_numpy(np.ascontiguousarray(pixels)).to(self.device)
            out = self._encode_pixels(px, normalize)
            out = out[:b].to(torch.float32).cpu().numpy()
        return out[0] if single else out

    def _encode_image_raw(self, imgs_u8: np.ndarray, *, normalize: bool,
                          single: bool) -> np.ndarray:
        """uint8 ``[B, H, W, 3]`` of one shape: ship uint8, preprocess on the
        device, encode."""
        b, h, w, _ = imgs_u8.shape
        bb = _bucket(b)
        if bb != b:
            imgs_u8 = np.concatenate([imgs_u8, np.repeat(imgs_u8[-1:], bb - b, axis=0)], axis=0)
        key = (h, w)
        if key not in self._prep_cache:
            self._prep_cache[key] = make_device_preprocess(
                h, w, self.config.vision.image_size, np.asarray(self.config.image_mean),
                np.asarray(self.config.image_std), self.device)
        with torch.inference_mode():
            u8 = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(self.device)
            out = self._encode_pixels(self._prep_cache[key](u8), normalize)
            out = out[:b].to(torch.float32).cpu().numpy()
        return out[0] if single else out

    def encode_class_names(self, names, *, templates=None) -> np.ndarray:
        """Class-name text embeddings for zero-shot classification.

        ``templates=None`` encodes the raw class names.  Otherwise each class
        is encoded through every template, the normalized per-prompt
        embeddings are averaged and the mean is re-normalized.  Returns
        normalized [C, D]."""
        from .templates import resolve_templates

        names = list(names)
        tpl = resolve_templates(templates)
        if tpl is None:
            return self.encode_text(names, normalize=True)
        prompts = [t.format(n) for n in names for t in tpl]
        vecs = self.encode_text(prompts, normalize=True)
        vecs = vecs.reshape(len(names), len(tpl), -1).mean(axis=1)
        vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
        return vecs.astype(np.float32)

    def compare_text_and_image(self, text: str, image) -> float:
        """End-to-end similarity of normalized embeddings."""
        return similarity_score(self.encode_text(text, normalize=True),
                                self.encode_image(image, normalize=True))

    def zero_shot_label_image(self, image, labels: Sequence[str], *,
                              templates=None) -> tuple[np.ndarray, np.ndarray]:
        """Zero-shot labeling: softmax over raw dot products of *unnormalized*
        embeddings; with ``templates``, labels are prompt-ensembled and the
        normalized scores scaled by 100.  Returns (sorted_scores, indices
        into labels)."""
        if len(labels) < 2:
            raise ValueError("zero-shot labeling needs at least 2 labels")
        if templates is None:
            ivec = self.encode_image(image, normalize=False)
            sims = self.encode_text(list(labels), normalize=False) @ ivec
        else:
            ivec = self.encode_image(image, normalize=True)
            sims = 100.0 * (self.encode_class_names(labels, templates=templates) @ ivec)
        return softmax_with_sorting(sims)

    def close(self) -> None:
        self.reader.close()
