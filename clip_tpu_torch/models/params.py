"""Parameters loaded from GGUF checkpoints, as dicts of torch tensors.

Same layout as the JAX package's ``models/params.py``: per-layer weights are
stacked along a leading layer axis; Q/K/V are fused into one ``[3H, H]``
projection; quantized 2-D weights stay packed as :class:`QTensor` leaves;
biases and norms stay float32.  Names follow function, not the GGUF's
historical swap: ``up_*`` comes from ``ffn_down`` tensors, ``down_*`` from
``ffn_up``.

Loading runs on the host in numpy (``load_params_np``), including the
re-quantization of the layer weights to per-channel int8
(:func:`convert_layers_to_w8`), so the int8 codes and scales equal the JAX
package's by construction; :func:`params_from_numpy` then moves the tree to
a device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..gguf import GGMLType, GGUFReader
from ..gguf import constants as C
from ..ops.qtensor import QTensor, W8Tensor, from_ggml_blocks, to_w8tensor
from .config import ClipConfig

LAYER_TENSORS = {
    # param name -> (template, kind)   kind: "weight" | "bias"
    "ln1_w": (C.TN_LN_1, "weight"),
    "ln1_b": (C.TN_LN_1, "bias"),
    "o_w": (C.TN_ATTN_OUTPUT, "weight"),
    "o_b": (C.TN_ATTN_OUTPUT, "bias"),
    "ln2_w": (C.TN_LN_2, "weight"),
    "ln2_b": (C.TN_LN_2, "bias"),
    "up_w": (C.TN_FFN_DOWN, "weight"),    # GGUF "ffn_down" == HF fc1 == up-proj
    "up_b": (C.TN_FFN_DOWN, "bias"),
    "down_w": (C.TN_FFN_UP, "weight"),    # GGUF "ffn_up" == HF fc2 == down-proj
    "down_b": (C.TN_FFN_UP, "bias"),
}
_QKV_TENSORS = (C.TN_ATTN_Q, C.TN_ATTN_K, C.TN_ATTN_V)
_QUANT_TYPES = {GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0}
W8_LAYER_WEIGHTS = ("qkv_w", "o_w", "up_w", "down_w")


def _load_tensor(reader: GGUFReader, name: str) -> Any:
    """One tensor as numpy: a QTensor if block-quantized, else float32."""
    info = reader.tensors.get(name)
    if info is None:
        raise KeyError(f"missing tensor {name!r} in {reader.path}")
    if info.ggml_type in _QUANT_TYPES:
        return from_ggml_blocks(reader.tensor_data(name), info.shape, info.ggml_type)
    return np.array(reader.tensor_as_float(name), np.float32)


def _join(leaves: list[Any], fn) -> Any:
    """Stack or concatenate numpy leaves (QTensor-aware)."""
    if isinstance(leaves[0], QTensor):
        return QTensor(
            q=fn([l.q for l in leaves]), d=fn([l.d for l in leaves]),
            m=None if leaves[0].m is None else fn([l.m for l in leaves]),
            qtype=leaves[0].qtype,
            hb=None if leaves[0].hb is None else fn([l.hb for l in leaves]))
    return fn(leaves)


def _load_layers(reader, tower: str, n_layer: int) -> dict:
    per_name: dict[str, list[Any]] = {k: [] for k in LAYER_TENSORS}
    per_name["qkv_w"] = []
    per_name["qkv_b"] = []
    for il in range(n_layer):
        for pname, (tmpl, kind) in LAYER_TENSORS.items():
            per_name[pname].append(_load_tensor(reader, tmpl.format(t=tower, i=il, w=kind)))
        per_name["qkv_w"].append(_join(
            [_load_tensor(reader, t.format(t=tower, i=il, w="weight")) for t in _QKV_TENSORS],
            lambda xs: np.concatenate(xs, axis=0)))
        per_name["qkv_b"].append(np.concatenate(
            [_load_tensor(reader, t.format(t=tower, i=il, w="bias")) for t in _QKV_TENSORS]))
    return {k: _join(v, np.stack) for k, v in per_name.items()}


def load_params_np(reader: GGUFReader, cfg: ClipConfig | None = None) -> dict:
    """All towers of the checkpoint as a numpy tree."""
    cfg = cfg or ClipConfig.from_gguf(reader)
    params: dict = {}
    if cfg.has_text:
        t = "t"
        params["text"] = {
            "tok_embd": _load_tensor(reader, C.TN_TOKEN_EMBD.format(t=t)),
            "pos_embd": _load_tensor(reader, C.TN_POS_EMBD.format(t=t)),
            "layers": _load_layers(reader, t, cfg.text.n_layer),
            "post_ln_w": _load_tensor(reader, C.TN_LN_POST.format(t=t, w="weight")),
            "post_ln_b": _load_tensor(reader, C.TN_LN_POST.format(t=t, w="bias")),
            "proj": _load_tensor(reader, C.TN_TEXT_PROJ),
        }
    if cfg.has_vision:
        t = "v"
        params["vision"] = {
            "class_embd": _load_tensor(reader, C.TN_CLASS_EMBD),
            "patch_embd": _load_tensor(reader, C.TN_PATCH_EMBD),
            "pos_embd": _load_tensor(reader, C.TN_POS_EMBD.format(t=t)),
            "pre_ln_w": _load_tensor(reader, C.TN_LN_PRE.format(t=t, w="weight")),
            "pre_ln_b": _load_tensor(reader, C.TN_LN_PRE.format(t=t, w="bias")),
            "layers": _load_layers(reader, t, cfg.vision.n_layer),
            "post_ln_w": _load_tensor(reader, C.TN_LN_POST.format(t=t, w="weight")),
            "post_ln_b": _load_tensor(reader, C.TN_LN_POST.format(t=t, w="bias")),
            "proj": _load_tensor(reader, C.TN_VIS_PROJ),
        }
    return params


def convert_layers_to_w8(params: dict) -> dict:
    """Re-quantize each tower's stacked block-quantized layer weights
    (``qkv_w``, ``o_w``, ``up_w``, ``down_w``) to per-channel int8 on the host,
    as the JAX package's ``engine.py:74 _convert_layers_to_w8`` does.
    Embeddings, norms and the output projections keep their source format."""
    out = dict(params)
    for tower in ("text", "vision"):
        if tower not in out:
            continue
        layers = dict(out[tower]["layers"])
        for name in W8_LAYER_WEIGHTS:
            if isinstance(layers[name], QTensor):
                layers[name] = to_w8tensor(layers[name])
        out[tower] = {**out[tower], "layers": layers}
    return out


def _leaf_to_torch(leaf, device) -> Any:
    # duck-typed so that the JAX package's QTensor / W8Tensor leaves (with
    # numpy fields) convert too, without importing that package
    if hasattr(leaf, "c8"):
        return W8Tensor(c8=leaf.c8, ws=leaf.ws, qtype=GGMLType(int(leaf.qtype))).to(device)
    if hasattr(leaf, "q") and hasattr(leaf, "d"):
        return QTensor(q=leaf.q, d=leaf.d, m=leaf.m, qtype=GGMLType(int(leaf.qtype)),
                       hb=leaf.hb).to(device)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes; torch.from_numpy rejects it
        return torch.from_numpy(arr.astype(np.float32)).to(device).to(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements=("C", "W"))).to(device)


def params_from_numpy(tree: dict, device) -> dict:
    """A (nested dict) parameter tree whose leaves are numpy arrays or
    QTensor / W8Tensor objects with numpy fields -> the same tree of torch
    tensors on ``device``.  Accepts the JAX package's parameter pytree after
    its leaves were pulled to numpy."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict) else _leaf_to_torch(v, device)
            for k, v in tree.items()}


def load_params(reader: GGUFReader, cfg: ClipConfig | None = None, *, device) -> dict:
    """Load a checkpoint, re-quantize the layer weights to int8 and move the
    tree to ``device``."""
    return params_from_numpy(convert_layers_to_w8(load_params_np(reader, cfg)), device)
