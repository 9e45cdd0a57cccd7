"""The port's kernel modules against the JAX package's Pallas kernels.

Both sides get the same numpy inputs, made from a seed: the weights are one
layer of the 128-wide q4_0 two-tower checkpoint (the smallest width at which
the JAX package's fusion gates engage), re-quantized to int8 by each side.
The JAX kernels run in interpret mode, as the JAX package's own CPU tests
run them; the port runs its plain versions on the CPU in float32 (a CPU
tensor takes the plain version in every wrapper).  Bounds are the JAX
package's own: ``tests/test_actquant_fusion.py:347-351`` for the blocks,
``tests/test_qmatmul.py:19`` for the dequant-GEMM.
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
from clip_tpu.ops.attention_pallas import attn_block_pallas
from clip_tpu.ops.linear import quant_rows as jax_quant_rows
from clip_tpu.ops.qmatmul_pallas import qmatmul_pallas

from clip_tpu_torch.gguf import GGUFReader
from clip_tpu_torch.gguf.constants import GGMLType
from clip_tpu_torch.models.params import convert_layers_to_w8, load_params_np
from clip_tpu_torch.ops import nn as tnn
from clip_tpu_torch.ops import qtensor as tqt
from clip_tpu_torch.ops.actquant import mlp_lnq
from clip_tpu_torch.ops.attention import attn_block
from clip_tpu_torch.ops.linear import qmatmul, w8a8_matmul
from clip_tpu_torch.ops.qmatmul import qmatmul_q4
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
