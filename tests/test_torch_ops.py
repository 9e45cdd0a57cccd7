"""The port's kernel modules against the JAX package's Pallas kernels.

Both sides get the same numpy inputs, made from a seed: the weights are one
layer of the 128-wide q4_0 two-tower checkpoint (the smallest width at which
the JAX package's fusion gates engage), re-quantized to int8 by each side,
or random q4/q5/q8 block weights and fused qkv activations.
The JAX kernels run in interpret mode, as the JAX package's own CPU tests
run them; the port runs its plain versions on the CPU in float32 (a CPU
tensor takes the plain version in every wrapper).  Bounds are the JAX
package's own: ``tests/test_actquant_fusion.py:347-351`` for the blocks,
``tests/test_qmatmul.py:19`` for the dequant-GEMM, ``tests/test_attention_pallas.py``
(1e-4) for ``mha_pallas_qkv``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_tpu.gguf import GGUFReader as JaxReader
from clip_tpu.models.params import load_params as jax_load_params
from clip_tpu.ops import nn as jnn
from clip_tpu.ops import qtensor as jqt
from clip_tpu.ops.actquant_pallas import mlp_lnq_pallas
from clip_tpu.ops.attention_pallas import _flat_block_b, attn_block_pallas, mha_pallas_qkv
from clip_tpu.ops.linear import quant_rows as jax_quant_rows
from clip_tpu.ops.qmatmul_pallas import qmatmul_pallas

from clip_tpu_torch.gguf import GGUFReader
from clip_tpu_torch.gguf.constants import GGMLType
from clip_tpu_torch.models.params import convert_layers_to_w8, load_params_np
from clip_tpu_torch.ops import nn as tnn
from clip_tpu_torch.ops import qtensor as tqt
from clip_tpu_torch.ops.actquant import mlp_lnq, requant
from clip_tpu_torch.ops.attention import (SMEM_LIMIT, attention_heads, attention_smem,
                                          attn_block, mha_qkv)
from clip_tpu_torch.ops.linear import fused_route, qmatmul, w8a8_matmul
from clip_tpu_torch.ops.qmatmul import qmatmul_q4, qmatmul_q5, qmatmul_q8
from clip_tpu_torch.quant import quantize
from test_actquant_fusion import _w128_q4_gguf

EPS = 1e-5
BLOCK_TOL = dict(atol=5e-2, rtol=5e-2)
QMM_TOL = dict(atol=1e-4, rtol=1e-4)


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


@pytest.fixture(scope="module")
def w128_path(tmp_path_factory):
    return _w128_q4_gguf(tmp_path_factory.mktemp("w128"))


@pytest.fixture(scope="module")
def layer0(w128_path):
    """Vision layer 0 of the w128 checkpoint: the JAX package's numpy QTensor
    leaves and the port's W8 conversion of its own load."""
    with JaxReader(w128_path) as r:
        jp = jax_load_params(r)["vision"]["layers"]
    with GGUFReader(w128_path) as r:
        tp = convert_layers_to_w8(load_params_np(r))["vision"]["layers"]
    return jp, tp


def _lp0(tp):
    """Layer 0 of the port's numpy tree as torch tensors."""
    out = {}
    for k, v in tp.items():
        if isinstance(v, tqt.W8Tensor):
            out[k] = tqt.W8Tensor(c8=_t(v.c8[0]), ws=_t(v.ws[0]), qtype=v.qtype)
        else:
            out[k] = _t(v[0])
    return out


@pytest.mark.parametrize("name", ["qkv_w", "o_w", "up_w", "down_w"])
def test_to_w8tensor_bit_equal(layer0, name):
    jp, tp = layer0
    ref = jqt.to_w8tensor(jp[name])
    np.testing.assert_array_equal(tp[name].c8, np.asarray(ref.c8))
    np.testing.assert_array_equal(tp[name].ws, np.asarray(ref.ws))


@pytest.mark.parametrize("mode", ["plain", "causal", "valid_len"])
def test_attn_block_matches_pallas(layer0, mode):
    jp, tp = layer0
    lp = _lp0(tp)
    h, nh = 128, 4
    x = np.random.default_rng(1).normal(0, 1, (4, 8, h)).astype(np.float32)
    causal = mode == "causal"
    vl = 6 if mode == "valid_len" else None
    q8, o8 = lp["qkv_w"], lp["o_w"]
    ref = attn_block_pallas(
        jnp.asarray(x), jnp.asarray(lp["ln1_w"]), jnp.asarray(lp["ln1_b"]),
        jnp.asarray(q8.c8), jnp.asarray(q8.ws), jnp.asarray(lp["qkv_b"]),
        jnp.asarray(o8.c8), jnp.asarray(o8.ws), jnp.asarray(lp["o_b"]),
        n_head=nh, scale=1.0 / (h // nh) ** 0.5, eps=EPS, causal=causal,
        interpret=True, valid_len=vl, out_dtype=jnp.float32, residual=True)
    out = attn_block(torch.from_numpy(x), lp["ln1_w"], lp["ln1_b"], q8.c8, q8.ws,
                     lp["qkv_b"], o8.c8, o8.ws, lp["o_b"], n_head=nh,
                     scale=1.0 / (h // nh) ** 0.5, eps=EPS, causal=causal, valid_len=vl)
    assert out.dtype == torch.float32 and out.shape == x.shape
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, **BLOCK_TOL)
    assert _cos(out.numpy(), ref) > 0.9999


@pytest.mark.parametrize("act", ["gelu_quick", "gelu_tanh"])
def test_mlp_lnq_matches_pallas(layer0, act):
    jp, tp = layer0
    lp = _lp0(tp)
    x = np.random.default_rng(2).normal(0, 1, (40, 128)).astype(np.float32)
    up, dn = lp["up_w"], lp["down_w"]
    ref = mlp_lnq_pallas(
        jnp.asarray(x), jnp.asarray(lp["ln2_w"]), jnp.asarray(lp["ln2_b"]),
        jnp.asarray(up.c8), jnp.asarray(up.ws), jnp.asarray(lp["up_b"]),
        jnp.asarray(dn.c8), jnp.asarray(dn.ws), jnp.asarray(lp["down_b"]),
        eps=EPS, act=act, interpret=True, out_dtype=jnp.float32, residual=True)
    out = mlp_lnq(torch.from_numpy(x), lp["ln2_w"], lp["ln2_b"], up.c8, up.ws, lp["up_b"],
                  dn.c8, dn.ws, lp["down_b"], eps=EPS, act=act)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, **BLOCK_TOL)
    assert _cos(out.numpy(), ref) > 0.9999


def _both_qt(rng, n, k, qtype):
    w = rng.normal(0, 0.05, (n, k)).astype(np.float32)
    packed = quantize(w, qtype)
    return (jqt.from_ggml_blocks(packed, (n, k), int(qtype)),
            tqt.from_ggml_blocks(packed, (n, k), qtype))


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q4_1])
@pytest.mark.parametrize("m", [13, 64])
def test_qmatmul_q4_matches_pallas(qtype, m):
    rng = np.random.default_rng(3)
    n, k = 200, 128
    jw, tw = _both_qt(rng, n, k, qtype)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = np.asarray(qmatmul_pallas(jnp.asarray(x), jw, compute_dtype=jnp.float32,
                                    interpret=True))
    out = qmatmul_q4(torch.from_numpy(x), tw.to("cpu"))
    np.testing.assert_allclose(out.numpy(), ref, **QMM_TOL)


@pytest.mark.parametrize("qtype,fn", [(GGMLType.Q5_0, qmatmul_q5), (GGMLType.Q5_1, qmatmul_q5),
                                      (GGMLType.Q8_0, qmatmul_q8)])
@pytest.mark.parametrize("m", [1, 64, 300])
def test_qmatmul_q5_q8_match_pallas(qtype, fn, m):
    """The plain versions of the packed5 and bytes bodies (the wrappers on a
    CPU tensor) against ``qmatmul_pallas`` in interpret mode."""
    rng = np.random.default_rng(8)
    n, k = 200, 256
    jw, tw = _both_qt(rng, n, k, qtype)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = np.asarray(qmatmul_pallas(jnp.asarray(x), jw, compute_dtype=jnp.float32,
                                    interpret=True))
    out = fn(torch.from_numpy(x), tw.to("cpu"))
    np.testing.assert_allclose(out.numpy(), ref, **QMM_TOL)


def test_qmatmul_wrappers_reject_other_formats():
    rng = np.random.default_rng(9)
    _, w8 = _both_qt(rng, 32, 64, GGMLType.Q8_0)
    _, w5 = _both_qt(rng, 32, 64, GGMLType.Q5_1)
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        qmatmul_q4(x, w8.to("cpu"))
    with pytest.raises(ValueError):
        qmatmul_q8(x, w5.to("cpu"))
    with pytest.raises(ValueError):
        qmatmul_q5(x, w8.to("cpu"))


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q5_1, GGMLType.Q8_0])
@pytest.mark.parametrize("rows", [2048, 2049])
def test_fused_route_matches_jax_resolve(qtype, rows, monkeypatch):
    """The port sends a projection to its fused kernel exactly where the JAX
    package's ``auto`` backend on a TPU sends it to ``qmatmul_pallas``."""
    import importlib

    L = importlib.import_module("clip_tpu.ops.linear")
    monkeypatch.setattr(L.jax, "default_backend", lambda: "tpu")
    jw, tw = _both_qt(np.random.default_rng(10), 32, 64, qtype)
    want = L._resolve("auto", jnp.zeros((rows, 64), jnp.float32), jw) == "pallas"
    assert fused_route(tw, rows) == want
    assert want == (qtype != GGMLType.Q5_1 and rows <= 2048 or qtype == GGMLType.Q5_1)


def _qkv(seed, b, s, n_head, dh):
    return np.random.default_rng(seed).normal(0, 1, (b, s, 3 * n_head * dh)).astype(np.float32)


@pytest.mark.parametrize("b,body", [(4, "flat"), (2, "padded")])
@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("mode", ["plain", "causal", "valid_len"])
def test_mha_qkv_matches_pallas(b, body, dh, mode):
    """``mha_qkv``'s plain version against both bodies of ``mha_pallas_qkv``
    (interpret mode, f32): (B = 4, S = 50) takes the flat body, (B = 2,
    S = 50) the padded 3-D one."""
    s, nh = 50, 2
    h3 = 3 * nh * dh
    assert (_flat_block_b(b, s, h3) is not None) == (body == "flat")
    x = _qkv(11, b, s, nh, dh)
    kw = dict(n_head=nh, scale=dh ** -0.5, causal=mode == "causal",
              valid_len=37 if mode == "valid_len" else None)
    ref = np.asarray(mha_pallas_qkv(jnp.asarray(x), interpret=True, **kw))
    out = mha_qkv(torch.from_numpy(x), **kw)
    assert out.dtype == torch.float32 and out.shape == (b, s, nh * dh)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,dh", [(50, 64), (80, 64), (257, 80), (577, 64), (584, 64),
                                  (640, 64), (640, 80)])
def test_attention_core_fits_every_single_image_sequence(s, dh):
    """The card's attention core holds every sequence ``mha_pallas_qkv``
    takes one image at a time (S <= 640) at d_head 64 and 80 in one block's
    shared memory; staging Q as well (the first version) did not fit
    ViT-L/14-336's S = 577."""
    assert attention_smem(s, dh) <= SMEM_LIMIT
    assert 3 * 577 * (64 + 2) * 2 + 4 * 577 * 4 > SMEM_LIMIT


# (variant, tower, images, S the tower runs at): the vision towers at their
# pad-once S (ViT-B/16 at 384 px as the streamed-block path), the text
# towers at 77 padded to 80
_CATALOG_ATTENTION = [("ViT-B/32", "vision", 64, 50), ("ViT-B/32", "text", 8, 80),
                      ("ViT-B/16", "vision", 1, 584), ("ViT-B/16", "vision", 8, 584),
                      ("ViT-L/14-336", "vision", 4, 584), ("ViT-L/14", "text", 8, 80),
                      ("ViT-H/14", "vision", 64, 264), ("ViT-H/14", "text", 8, 80)]


@pytest.mark.parametrize("variant,tower,b,s", _CATALOG_ATTENTION)
@pytest.mark.parametrize("kind", ["bf16", "i8"])
def test_attention_plan_at_catalog_shapes(variant, tower, b, s, kind):
    """The tensor-core cores launch one block of four warps per 64 query
    rows of a head of an image (so 120 blocks at ViT-B/16-384 B = 1, 960 at
    B = 8, 768 at ViT-B/32 vision B = 64), with shared memory that does not
    grow with S; the int8 core pads d_head to a multiple of 32."""
    from clip_tpu_torch.ops.attention import attention_i8_smem, attention_plan
    from clip_tpu_torch.synth import VARIANTS

    v = VARIANTS[variant]
    nh, width = (v.v_heads, v.v_hidden) if tower == "vision" else (v.t_heads, v.t_hidden)
    dh = width // nh
    plan = attention_plan(b, s, nh, dh, kind)
    assert plan["grid"] == (-(-s // 64), nh, b) and plan["threads"] == 128
    smem = attention_smem(s, dh) if kind == "bf16" else attention_i8_smem(s, dh)
    assert plan["smem"] == smem == (attention_smem(4096, dh) if kind == "bf16"
                                    else attention_i8_smem(4096, dh))
    assert plan["smem"] <= 64 * 1024
    assert plan["dh_pad"] == (dh if kind == "bf16" else -(-dh // 32) * 32)
    blocks = {("ViT-B/32", "vision", 64): 768, ("ViT-B/16", "vision", 1): 120,
              ("ViT-B/16", "vision", 8): 960}.get((variant, tower, b))
    if blocks is not None:
        assert plan["grid"][0] * plan["grid"][1] * plan["grid"][2] == blocks


@pytest.mark.parametrize("dh,kind,match", [(72, "bf16", "multiple of 16"),
                                           (144, "i8", "multiple of 16"),
                                           (8, "bf16", "multiple of 16"),
                                           (81, "f32", "even")])
def test_attention_plan_rejects_what_the_kernels_do_not_take(dh, kind, match):
    from clip_tpu_torch.ops.attention import attention_plan

    with pytest.raises(ValueError, match=match):
        attention_plan(2, 50, 4, dh, kind)


def test_attention_plan_f32_keeps_the_shared_memory_bound():
    """The f32 form keeps the CUDA-core kernel, which holds a head's K and V
    in f32: S = 344 fits at d_head 80, S = 345 does not; the tensor-core
    cores take S = 700."""
    from clip_tpu_torch.ops.attention import attention_plan

    assert attention_plan(1, 344, 1, 80, "f32")["grid"] == (1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        attention_plan(1, 345, 1, 80, "f32")
    assert attention_plan(1, 700, 1, 80, "bf16")["grid"] == (11, 1, 1)


@pytest.mark.parametrize("mode", ["plain", "causal", "valid_len"])
def test_mha_qkv_quant_out_is_attention_then_requant(mode):
    """``mha_pallas_qkv(quant_out=True)`` is the f32 attention followed by
    the row requant: scales to 1e-6 relative, codes equal but for 1 at
    rounding ties."""
    b, s, nh, dh = 4, 50, 2, 64
    x = _qkv(12, b, s, nh, dh)
    kw = dict(n_head=nh, scale=dh ** -0.5, causal=mode == "causal",
              valid_len=37 if mode == "valid_len" else None)
    rc, rs = mha_pallas_qkv(jnp.asarray(x), interpret=True, quant_out=True, **kw)
    att = attention_heads(torch.from_numpy(x.reshape(b * s, -1)), b, s, nh, kw["scale"],
                          kw["causal"], kw["valid_len"])
    codes, sx = requant(att)
    np.testing.assert_allclose(sx.numpy(), np.asarray(rs).reshape(-1), rtol=1e-6, atol=0)
    diff = np.abs(codes.numpy().astype(np.int32) - np.asarray(rc).reshape(b * s, -1))
    assert diff.max() <= 1
    if diff.max():
        v = att.numpy() / sx.numpy()[:, None]
        assert np.abs(v - np.floor(v) - 0.5)[diff > 0].max() < 1e-3


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0,
                                   GGMLType.Q5_1, GGMLType.Q8_0])
def test_dequant_and_qmatmul_routing_match_oracle(qtype):
    """``dequant`` equals the JAX package's numpy oracle bit for bit, and the
    CPU ``qmatmul`` route (dequantize, then matmul) matches ``x @ W.T``."""
    rng = np.random.default_rng(4)
    jw, tw = _both_qt(rng, 64, 96, qtype)
    wt = tw.to("cpu")
    oracle = jqt.dequant_np(jw)
    np.testing.assert_array_equal(tqt.dequant(wt).numpy(), oracle)
    x = rng.normal(size=(5, 96)).astype(np.float32)
    out = qmatmul(torch.from_numpy(x), wt)
    np.testing.assert_allclose(out.numpy(), x @ oracle.T, **QMM_TOL)


def test_take_rows_matches_jax():
    rng = np.random.default_rng(5)
    jw, tw = _both_qt(rng, 50, 64, GGMLType.Q4_0)
    ids = np.array([[3, 0, 49], [7, 7, 1]], np.int64)
    ref = np.asarray(jqt.take_rows(jw, jnp.asarray(ids)))
    out = tqt.take_rows(tw.to("cpu"), torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_w8a8_matmul_matches_jax(layer0):
    jp, tp = layer0
    w = tp["up_w"]
    w0 = tqt.W8Tensor(c8=_t(w.c8[0]), ws=_t(w.ws[0]), qtype=w.qtype)
    jw = jqt.W8Tensor(c8=jnp.asarray(w.c8[0]), ws=jnp.asarray(w.ws[0]), qtype=w.qtype)
    x = np.random.default_rng(6).normal(0, 1, (9, 128)).astype(np.float32)
    from clip_tpu.ops.linear import w8a8_matmul as jax_w8a8
    ref = np.asarray(jax_w8a8(jnp.asarray(x), jw, jnp.float32))
    out = w8a8_matmul(torch.from_numpy(x), w0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["layernorm", "gelu_quick", "gelu_tanh", "l2_normalize",
                                "quant_rows"])
def test_nn_matches_jax(fn):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 2, (33, 96)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if fn == "layernorm":
        w = rng.normal(1, 0.1, 96).astype(np.float32)
        b = rng.normal(0, 0.1, 96).astype(np.float32)
        out = tnn.layernorm(xt, torch.from_numpy(w), torch.from_numpy(b), EPS).numpy()
        ref = np.asarray(jnn.layernorm(xj, jnp.asarray(w), jnp.asarray(b), EPS))
    elif fn == "quant_rows":
        codes, sx = tnn.quant_rows(xt)
        rc, rs = jax_quant_rows(xj)
        np.testing.assert_allclose(sx.numpy(), np.asarray(rs)[:, 0], rtol=1e-6)
        # rounding ties may flip a code by 1; all else identical
        diff = np.abs(codes.numpy().astype(np.int32) - np.asarray(rc, np.int32))
        assert diff.max() <= 1
        return
    else:
        out = getattr(tnn, fn)(xt).numpy()
        ref = np.asarray(getattr(jnn, fn)(xj))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
