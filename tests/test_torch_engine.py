"""The port's engine against the JAX package's engine on the 128-wide q4_0
two-tower checkpoint.

The JAX engine runs the fused W8A8 route with its Pallas kernels in
interpret mode (``act_quant=True, lnq_fuse=True, attn_impl="pallas"``, f32);
the port runs the same route through its plain versions on the CPU in f32.
Both get the same seeded inputs.  Embeddings must agree at per-row cos >
0.9999 (``tests/test_actquant_fusion.py:404``) and zero-shot labels must come
out in the same order.
"""

import numpy as np
import pytest
import torch

from clip_tpu.engine import ClipEngine as JaxEngine
from clip_tpu.preprocess import preprocess_batch as jax_preprocess_batch

from clip_tpu_torch.engine import ClipEngine, _bucket
from clip_tpu_torch.gguf.constants import GGMLType
from clip_tpu_torch.models import transformer
from clip_tpu_torch.models.params import params_from_numpy
from clip_tpu_torch.ops.qtensor import QTensor, W8Tensor
from clip_tpu_torch.preprocess import preprocess_batch
from test_actquant_fusion import _w128_q4_gguf

TEXTS = ["tok1 tok2", "tok2 tok3 tok4", "tok5", "tok9 tok8 tok7 tok6 tok5"]
LABELS = ["tok1", "tok3 tok4", "tok7", "tok2 tok8"]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = _w128_q4_gguf(tmp_path_factory.mktemp("w128e"))
    ref = JaxEngine(path, verbosity=0, act_quant=True, lnq_fuse=True, attn_impl="pallas",
                    compute_dtype="float32")
    port = ClipEngine(path, device="cpu", verbosity=0)
    yield path, ref, port
    ref.close()
    port.close()


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [(rng.random((40 + 3 * i, 36 + 5 * i, 3)) * 255).astype(np.uint8) for i in range(3)]


def _row_cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_port_engine_defaults(engines):
    _, _, port = engines
    assert port.device.type == "cpu" and port.compute_dtype == torch.float32
    assert isinstance(port.params["vision"]["layers"]["qkv_w"], W8Tensor)
    assert isinstance(port.params["vision"]["proj"], QTensor)


def test_preprocess_matches_jax(engines, images):
    _, ref, port = engines
    cfg = port.config
    a = preprocess_batch(images, cfg.vision.image_size, np.asarray(cfg.image_mean),
                         np.asarray(cfg.image_std))
    b = jax_preprocess_batch(images, cfg.vision.image_size, np.asarray(cfg.image_mean),
                             np.asarray(cfg.image_std))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.preprocess(images), a)


def test_tokenizer_matches_jax(engines):
    _, ref, port = engines
    for t in TEXTS:
        assert port.tokenize(t) == ref.tokenize(t)


@pytest.mark.parametrize("normalize", [True, False])
def test_image_embeddings_match(engines, images, normalize):
    _, ref, port = engines
    pixels = port.preprocess(images)
    a = port.encode_image(pixels, normalize=normalize)
    b = ref.encode_image(pixels, normalize=normalize)
    assert a.shape == b.shape == (3, port.projection_dim)
    assert _row_cos(a, b).min() > 0.9999, _row_cos(a, b)
    # uint8 input goes through the host preprocess to the same result
    np.testing.assert_array_equal(port.encode_image(images, normalize=normalize), a)


@pytest.mark.parametrize("normalize", [True, False])
def test_text_embeddings_match(engines, normalize):
    _, ref, port = engines
    a = port.encode_text(TEXTS, normalize=normalize)
    b = ref.encode_text(TEXTS, normalize=normalize)
    assert a.shape == b.shape
    assert _row_cos(a, b).min() > 0.9999, _row_cos(a, b)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)


def test_zero_shot_labels_same_order(engines, images):
    _, ref, port = engines
    pixels = port.preprocess(images[:1])[0]
    sa, ia = port.zero_shot_label_image(pixels, LABELS)
    sb, ib = ref.zero_shot_label_image(pixels, LABELS)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, atol=1e-3)


def test_compare_and_class_names(engines, images):
    _, ref, port = engines
    pixels = port.preprocess(images[:1])[0]
    assert abs(port.compare_text_and_image(TEXTS[0], pixels)
               - ref.compare_text_and_image(TEXTS[0], pixels)) < 1e-3
    tpl = ["a {}.", "the {}"]
    a = port.encode_class_names(LABELS[:2], templates=tpl)
    b = ref.encode_class_names(LABELS[:2], templates=tpl)
    assert _row_cos(a, b).min() > 0.9999


def test_params_from_numpy_matches_loader(engines):
    """The JAX engine's parameter tree, pulled to numpy, converts into the
    port's tree with the same int8 codes and the same float leaves."""
    import jax

    _, ref, port = engines
    tree = jax.tree.map(np.asarray, ref.params)
    conv = params_from_numpy(tree, "cpu", torch.float32)
    for tower in ("text", "vision"):
        for name in ("qkv_w", "o_w", "up_w", "down_w"):
            a, b = conv[tower]["layers"][name], port.params[tower]["layers"][name]
            assert torch.equal(a.c8, b.c8) and torch.equal(a.ws, b.ws)
        for name in ("qkv_b", "ln1_w", "down_b"):
            assert torch.equal(conv[tower]["layers"][name], port.params[tower]["layers"][name])
        assert torch.equal(conv[tower]["proj"].q, port.params[tower]["proj"].q)


def test_port_with_jax_params_matches(engines):
    """Identical weights fed to both sides (the JAX tree converted with
    params_from_numpy) give the same text embeddings as the port's own load."""
    import jax

    _, ref, port = engines
    conv = params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu", torch.float32)
    saved = port.params
    try:
        port.params = conv
        a = port.encode_text(TEXTS)
    finally:
        port.params = saved
    np.testing.assert_array_equal(a, port.encode_text(TEXTS))


def test_buckets():
    assert [_bucket(n) for n in (1, 3, 8, 9, 1024, 1025)] == [1, 4, 8, 16, 1024, 2048]


def test_cuda_is_the_default_device(engines):
    path, _, _ = engines
    if torch.cuda.is_available():
        assert ClipEngine(path, verbosity=0).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ClipEngine(path, verbosity=0)


def _zero_w8_layer(h: int, f: int) -> dict:
    """A W8A8 layer of zero weights at width ``h`` and MLP width ``f``."""
    w8 = lambda n, k: W8Tensor(c8=torch.zeros(n, k, dtype=torch.int8),  # noqa: E731
                               ws=torch.ones(n), qtype=GGMLType.Q4_0)
    ones, zeros = torch.ones, torch.zeros
    return {"ln1_w": ones(h), "ln1_b": zeros(h), "qkv_w": w8(3 * h, h), "qkv_b": zeros(3 * h),
            "o_w": w8(h, h), "o_b": zeros(h), "ln2_w": ones(h), "ln2_b": zeros(h),
            "up_w": w8(f, h), "up_b": zeros(f), "down_w": w8(h, f), "down_b": zeros(h)}


@pytest.mark.parametrize("row", ["attn_block_stream", "mlp_lnq_stream"])
def test_other_routes_raise(row, monkeypatch):
    """The two W8A8 routes whose TPU kernels stream their weights (rows 8
    and 9 of the kernel table), which the port once refused, now run: where
    the JAX package takes them, the port calls its streaming wrapper and
    returns finite output.  Row 8 is reached at width 768 and S = 584 (a
    ViT-B/16 tower at 384 px); row 9 by ``mlp_stream=True`` at ViT-H/14's
    MLP widths."""
    from clip_tpu_torch.ops import actquant, attention

    if row == "attn_block_stream":
        h, f, s, flags, mod = 768, 3072, 584, {}, attention
    else:
        h, f, s, flags, mod = 1280, 5120, 8, dict(mlp_stream=True), actquant
    calls = []
    fn = getattr(mod, row)
    monkeypatch.setattr(mod, row, lambda *a, **k: calls.append(row) or fn(*a, **k))
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (1, s, h)).astype(np.float32))
    out = transformer.block(x, _zero_w8_layer(h, f), n_head=h // 64, eps=1e-5, use_gelu=False,
                            **flags)
    assert calls == [row]
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_dense_layer_weights_take_the_dense_route(engines):
    """Dense layer weights (the int8 weights dequantized) take the dense
    route under every flag set, and match the JAX package's dense block
    (``mha_pallas_qkv`` in interpret mode); a mix of int8 and dense layer
    weights raises."""
    import jax.numpy as jnp
    from clip_tpu.models import transformer as jax_transformer

    _, _, port = engines
    lp = transformer.layer(port.params["text"]["layers"], 0)
    dense = {k: (v.c8.to(torch.float32) * v.ws[:, None] if isinstance(v, W8Tensor) else v)
             for k, v in lp.items()}
    assert transformer.route(dense) == "dense" and transformer.route(lp) == "w8a8"
    x = np.random.default_rng(3).normal(0, 1, (2, 16, port.config.text.hidden_size))
    x = x.astype(np.float32)
    kw = dict(n_head=port.config.text.n_head, eps=1e-5, use_gelu=False, causal=True)
    ref = np.asarray(jax_transformer.block(
        jnp.asarray(x), {k: jnp.asarray(v.numpy()) for k, v in dense.items()},
        compute_dtype=jnp.float32, attn_impl="pallas", **kw))
    for flags in (dict(), dict(lnq_fuse=False), dict(attn_block=False), dict(mlp_full=False)):
        out = transformer.block(torch.from_numpy(x), dense, **kw, **flags).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError):
        transformer.block(torch.from_numpy(x), {**dense, "o_w": lp["o_w"]}, **kw)
