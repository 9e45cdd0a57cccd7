"""The port's engine against the JAX package's engine on f32, f16, q5_1 and
q8_0 checkpoints.

* f32 and f16: the tiny two-tower fixture (``tests/hf_fixtures.py:53``).
  Both engines keep the layer weights dense and take the dense route; the
  JAX engine runs ``mha_pallas_qkv`` in interpret mode
  (``attn_impl="pallas"``), the port ``mha_qkv``'s plain version, both in
  f32 on the CPU.
* q5_1 and q8_0: the 128-wide model of ``tests/test_actquant_fusion.py:354``
  re-quantized by the JAX package's quantizer, through both engines with
  the fused W8A8 route (``act_quant=True, lnq_fuse=True,
  attn_impl="pallas"``, f32) as in ``tests/test_torch_engine.py``.

Same seeded inputs on both sides; embeddings must agree at per-row cos >
0.9999 (``tests/test_actquant_fusion.py:404``) and zero-shot labels must
come out in the same order.
"""

import numpy as np
import pytest
import torch

from clip_tpu.engine import ClipEngine as JaxEngine
from clip_tpu.quantize import quantize_model

from clip_tpu_torch.engine import ClipEngine
from clip_tpu_torch.ops.qtensor import QTensor
from hf_fixtures import tiny_gguf
from test_actquant_fusion import _w128_q4_gguf

TEXTS = ["tok1 tok2", "tok2 tok3 tok4", "tok5", "tok9 tok8 tok7 tok6 tok5"]
LABELS = ["tok1", "tok3 tok4", "tok7", "tok2 tok8"]
CHECKPOINTS = ["f32", "f16", "q5_1", "q8_0"]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    out = {"f32": tiny_gguf(d, use_f32=True)[0], "f16": tiny_gguf(d, use_f32=False)[0]}
    _w128_q4_gguf(d)  # leaves the f32 source w128.gguf beside its q4_0
    for ft in ("q5_1", "q8_0"):
        out[ft] = str(d / f"w128.{ft}.gguf")
        quantize_model(str(d / "w128.gguf"), out[ft], ft, verbose=False)
    return out


@pytest.fixture(scope="module", params=CHECKPOINTS)
def engines(request, paths):
    ft = request.param
    kw = dict(act_quant=True, lnq_fuse=True) if ft.startswith("q") else {}
    ref = JaxEngine(paths[ft], verbosity=0, attn_impl="pallas", compute_dtype="float32", **kw)
    port = ClipEngine(paths[ft], device="cpu", verbosity=0)
    yield ft, ref, port
    ref.close()
    port.close()


def _row_cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _images():
    rng = np.random.default_rng(0)
    return [(rng.random((40 + 3 * i, 36 + 5 * i, 3)) * 255).astype(np.uint8) for i in range(3)]


def test_route_follows_the_checkpoint(engines):
    ft, _, port = engines
    assert port.route == ("w8a8" if ft.startswith("q") else "dense")
    assert isinstance(port.params["vision"]["proj"], QTensor) == ft.startswith("q")
    layers = port.params["vision"]["layers"]
    if port.route == "dense":
        assert layers["qkv_w"].dtype == torch.float32 and layers["qkv_b"].dtype == torch.float32


@pytest.mark.parametrize("normalize", [True, False])
def test_image_embeddings_match(engines, normalize):
    _, ref, port = engines
    pixels = port.preprocess(_images())
    a = port.encode_image(pixels, normalize=normalize)
    b = ref.encode_image(pixels, normalize=normalize)
    assert a.shape == b.shape == (3, port.projection_dim)
    assert _row_cos(a, b).min() > 0.9999, _row_cos(a, b)


@pytest.mark.parametrize("normalize", [True, False])
def test_text_embeddings_match(engines, normalize):
    _, ref, port = engines
    a = port.encode_text(TEXTS, normalize=normalize)
    b = ref.encode_text(TEXTS, normalize=normalize)
    assert a.shape == b.shape
    assert _row_cos(a, b).min() > 0.9999, _row_cos(a, b)


def test_zero_shot_labels_same_order(engines):
    _, ref, port = engines
    pixels = port.preprocess(_images()[:1])[0]
    sa, ia = port.zero_shot_label_image(pixels, LABELS)
    sb, ib = ref.zero_shot_label_image(pixels, LABELS)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, atol=1e-3)


def test_dense_weights_take_the_compute_dtype(paths):
    """bf16 compute: dense weights in bf16; biases, norms and the class
    embedding stay f32 (the JAX package's ``models/params.py:53-66``)."""
    port = ClipEngine(paths["f16"], device="cpu", compute_dtype="bfloat16", verbosity=0)
    v = port.params["vision"]
    assert v["layers"]["qkv_w"].dtype == torch.bfloat16
    assert v["patch_embd"].dtype == v["proj"].dtype == torch.bfloat16
    for name in ("qkv_b", "ln1_w", "ln2_b", "down_b"):
        assert v["layers"][name].dtype == torch.float32, name
    assert v["class_embd"].dtype == v["pre_ln_w"].dtype == torch.float32
    emb = port.encode_image(port.preprocess(_images()))
    assert np.isfinite(emb).all()
    port.close()


def test_params_from_numpy_takes_bf16_jax_trees(paths):
    """The JAX engine's bf16 parameter tree (ml_dtypes leaves) converts into
    the same tree as the port's own bf16 load."""
    import jax

    from clip_tpu_torch.models.params import params_from_numpy

    ref = JaxEngine(paths["f16"], verbosity=0, compute_dtype="bfloat16")
    port = ClipEngine(paths["f16"], device="cpu", compute_dtype="bfloat16", verbosity=0)
    tree = jax.tree.map(np.asarray, ref.params)
    assert tree["vision"]["layers"]["qkv_w"].dtype.name == "bfloat16"
    conv = params_from_numpy(tree, "cpu", torch.bfloat16)
    for tower in ("text", "vision"):
        for name, want in port.params[tower]["layers"].items():
            got = conv[tower]["layers"][name]
            assert got.dtype == want.dtype and torch.equal(got, want), (tower, name)
        assert torch.equal(conv[tower]["proj"], port.params[tower]["proj"])
    ref.close()
    port.close()
