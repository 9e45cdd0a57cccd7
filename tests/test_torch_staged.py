"""The port's staged W8A8 routes against the JAX package, on the CPU.

* The port's copies of the route gates equal the JAX package's functions on
  a grid of batch sizes and every geometry of ``synth.VARIANTS``, before and
  after the vision pad-once.
* The plain versions of ``lnq``, ``w8a8_pre``, ``gemm_gq``, ``mlp_gq`` and
  ``mha_qkv_i8`` (a CPU tensor takes the plain version in every wrapper)
  against the JAX functions, the Pallas ones in interpret mode.  Codes are
  equal except by 1 at rounding ties; scales within 1e-6 (``lnq``,
  attention) and 1e-5 (``gemm_gq``) relative, as
  ``tests/test_actquant_fusion.py:42, 110``; float outputs within 1e-4 in
  float32.
* ``block`` for every staged flag set against the JAX ``block``
  (``lnq_fuse=True, attn_impl="pallas"``, W8 weights that keep their q4_0
  source) at the 128-wide fixture, within the JAX package's block bound
  (``tests/test_actquant_fusion.py:347-351``: 5e-2 and cos > 0.9999), with
  the route each one takes.
* One ViT-L/14-336-wide layer at its pad-once S = 584 (valid 577) against
  the JAX block at B = 1 and 4, and beside it the fused chain that the port
  ran at S = 577 before it had the route gates.
* The small-row route to the kept source, device preprocessing, the engine
  with ``lnq_fuse=False``, and ``params_from_numpy`` with kept sources.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_tpu.engine import ClipEngine as JaxEngine
from clip_tpu.models import transformer as jtr
from clip_tpu.ops import actquant_pallas as jaq
from clip_tpu.ops import attention_pallas as jat
from clip_tpu.ops import qtensor as jqt
from clip_tpu.ops.device_preprocess import device_preprocess as jax_device_preprocess
from clip_tpu.ops.qmatmul_pallas import qmatmul_pallas
from clip_tpu.preprocess import preprocess_batch as jax_preprocess_batch
from clip_tpu.synth import VARIANTS

from clip_tpu_torch.engine import ClipEngine
from clip_tpu_torch.gguf import GGUFReader
from clip_tpu_torch.gguf.constants import GGMLType
from clip_tpu_torch.models import transformer
from clip_tpu_torch.models.config import VisionConfig
from clip_tpu_torch.models.params import load_params_np, params_from_numpy
from clip_tpu_torch.models.vision import pad_once
from clip_tpu_torch.ops import actquant as aq
from clip_tpu_torch.ops import attention as at
from clip_tpu_torch.ops import linear
from clip_tpu_torch.ops import qtensor as tqt
from clip_tpu_torch.ops.device_preprocess import device_preprocess
from clip_tpu_torch.ops.nn import layernorm_f32
from clip_tpu_torch.ops.qmatmul import qmatmul_plain
from clip_tpu_torch.quant import quantize
from test_actquant_fusion import _w128_q4_gguf

EPS = 1e-5
BLOCK_TOL = dict(atol=5e-2, rtol=5e-2)
BATCHES = (1, 2, 3, 4, 8, 64, 256)
MEAN = np.array([0.48145466, 0.4578275, 0.40821073])
STD = np.array([0.26862954, 0.26130258, 0.27577711])


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _same_codes(codes, scales, rc, rs, y, rtol):
    """Row-quant outputs against the JAX ones: scales within ``rtol``,
    codes equal except by 1 where ``y / scale`` sits at a rounding tie."""
    codes, rc = np.asarray(codes, np.int32), np.asarray(rc, np.int32).reshape(codes.shape)
    np.testing.assert_allclose(np.asarray(scales).reshape(-1), np.asarray(rs).reshape(-1),
                               rtol=rtol, atol=0)
    diff = np.abs(codes - rc)
    assert diff.max() <= 1
    if diff.max():
        v = np.asarray(y, np.float64).reshape(codes.shape) / np.asarray(rs).reshape(-1, 1)
        assert np.abs(v - np.floor(v) - 0.5)[diff > 0].max() < 1e-3


# -- route gates ----------------------------------------------------------------

def _geometries():
    """(name, tower, h, n_head, mlp, s) for every tower of the catalog; S is
    the unpadded sequence (text: 77 padded to 80 as both towers do)."""
    out = []
    for name, v in VARIANTS.items():
        out.append((name, "vision", v.v_hidden, v.v_heads, v.v_ff,
                    (v.image_size // v.patch_size) ** 2 + 1))
        out.append((name, "text", v.t_hidden, v.t_heads, v.t_ff, 80))
    return out


def _jax_pad_once(b, s, h, n_head, is_w8):
    """The JAX vision tower's pad-once rule (``clip_tpu/models/vision.py:107-111``)."""
    h3 = 3 * h
    if not jat.flat_eligible(b, s, h3) and ((h // n_head) % 64 == 0 or is_w8):
        sp = -(-s // 8) * 8
        if sp != s and jat.flat_eligible(b, sp, h3):
            return sp
    return s


@pytest.mark.parametrize("name,tower,h,n_head,mlp,s", _geometries(),
                         ids=[f"{g[0]}-{g[1]}" for g in _geometries()])
def test_route_gates_match_jax(name, tower, h, n_head, mlp, s):
    assert aq.fusable_width(h) == jaq.fusable_width(h)
    assert aq.mlp_fusable(h, mlp) == jaq.mlp_fusable(h, mlp)
    assert aq.mlp_stream_fusable(h, mlp) == jaq.mlp_stream_fusable(h, mlp)
    cfg = VisionConfig(image_size=224, patch_size=14, hidden_size=h, n_intermediate=mlp,
                       projection_dim=512, n_head=n_head, n_layer=1, eps=EPS)
    for b in BATCHES:
        seqs = {s}
        if tower == "vision":
            for is_w8 in (True, False):
                sp = pad_once(b, s, cfg, is_w8)
                assert sp == _jax_pad_once(b, s, h, n_head, is_w8)
                seqs.add(sp)
        seqs.add(-(-s // 8) * 8)
        for sq in sorted(seqs):
            for quant_out in (False, True):
                assert (at._flat_block_b(b, sq, 3 * h, quant_out)
                        == jat._flat_block_b(b, sq, 3 * h, quant_out))
                assert (at.flat_eligible(b, sq, 3 * h, quant_out)
                        == jat.flat_eligible(b, sq, 3 * h, quant_out))
            assert (at.attn_block_fusable(h, 3 * h, h, b, sq)
                    == jat.attn_block_fusable(h, 3 * h, h, b, sq))
            assert (at.attn_block_stream_fusable(h, 3 * h, h, b, sq, n_head=n_head)
                    == jat.attn_block_stream_fusable(h, 3 * h, h, b, sq, n_head=n_head))
            assert (at._ablk_stream_plan(b * sq, h, 3 * h, h, h // n_head)
                    == jat._ablk_stream_plan(b * sq, h, 3 * h, h, h // n_head))


def test_catalog_staged_routes():
    """The two places of the catalog where the JAX package takes a staged
    W8A8 route by default: ViT-L/14-336's vision attention at its pad-once
    S = 584 (neither attention block fits, and ``quant_o`` is off, so the
    bf16 attention output feeds the o projection) and ViT-H/14's vision MLP
    (its int8 weights are over the resident budget)."""
    v = VARIANTS["ViT-L/14-336"]
    cfg = VisionConfig(image_size=336, patch_size=14, hidden_size=v.v_hidden,
                       n_intermediate=v.v_ff, projection_dim=768, n_head=v.v_heads,
                       n_layer=1, eps=EPS)
    for b in BATCHES:
        assert pad_once(b, 577, cfg, True) == 584
        assert at.flat_eligible(b, 584, 3072)
        assert not at.attn_block_fusable(1024, 3072, 1024, b, 584)
        assert not at.attn_block_stream_fusable(1024, 3072, 1024, b, 584, n_head=16)
        assert not at.flat_eligible(b, 584, 3072, quant_out=True)
    assert not aq.mlp_fusable(1280, 5120) and aq.fusable_width(5120)
    assert not jaq.mlp_fusable(1280, 5120)
    assert aq.mlp_fusable(1024, 4096) and aq.mlp_fusable(768, 3072)


# -- kernels: plain versions against the JAX functions ----------------------

def _w8_np(rng, n, k):
    return tqt.to_w8tensor(rng.normal(0, 0.05, (n, k)).astype(np.float32))


def test_lnq_matches_pallas():
    rng = np.random.default_rng(20)
    x = rng.normal(0, 1, (70, 256)).astype(np.float32)
    w = rng.normal(1, 0.1, 256).astype(np.float32)
    b = rng.normal(0, 0.1, 256).astype(np.float32)
    rc, rs = jaq.lnq_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=EPS,
                            interpret=True)
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    codes, sx = aq.lnq(xt, wt, bt, EPS)
    assert codes.dtype == torch.int8 and sx.shape == (70,)
    _same_codes(codes, sx, rc, rs, layernorm_f32(xt, wt, bt, EPS), 1e-6)


def _codes(rng, m, k):
    codes = rng.integers(-127, 128, (m, k)).astype(np.int8)
    sx = rng.uniform(0.005, 0.05, m).astype(np.float32)
    return codes, sx


def test_w8a8_pre_matches_jax():
    rng = np.random.default_rng(21)
    codes, sx = _codes(rng, 37, 256)
    w = _w8_np(rng, 192, 256)
    jw = jqt.W8Tensor(c8=jnp.asarray(w.c8), ws=jnp.asarray(w.ws), qtype=w.qtype)
    ref = np.asarray(jaq.w8a8_pre(jnp.asarray(codes), jnp.asarray(sx[:, None]), jw,
                                  jnp.float32))
    out = aq.w8a8_pre(torch.from_numpy(codes), torch.from_numpy(sx), torch.from_numpy(w.c8),
                      torch.from_numpy(w.ws), torch.float32)
    assert out.dtype == torch.float32 and out.shape == (37, 192)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("act", ["gelu_quick", "gelu_tanh", "none"])
def test_gemm_gq_matches_pallas(act):
    rng = np.random.default_rng(22)
    codes, sx = _codes(rng, 45, 128)
    w = _w8_np(rng, 384, 128)
    bias = rng.normal(0, 0.1, 384).astype(np.float32)
    rc, rs = jaq.gemm_gq_pallas(jnp.asarray(codes), jnp.asarray(sx[:, None]),
                                jnp.asarray(w.c8), jnp.asarray(w.ws), jnp.asarray(bias),
                                act=act, interpret=True)
    c, s, w8, ws, b = (torch.from_numpy(a) for a in (codes, sx, w.c8, w.ws, bias))
    oc, osx = aq.gemm_gq(c, s, w8, ws, b, act)
    y = aq.gemm_i8_plain(c, w8, s, ws, b, {"gelu_quick": aq.GELU_QUICK,
                                          "gelu_tanh": aq.GELU_TANH, "none": aq.BIAS_F32}[act])
    assert oc.shape == (45, 384) and osx.shape == (45,)
    _same_codes(oc, osx, rc, rs, y, 1e-5)


@pytest.mark.parametrize("act", ["gelu_quick", "gelu_tanh"])
def test_mlp_gq_matches_pallas(act):
    rng = np.random.default_rng(23)
    codes, sx = _codes(rng, 52, 128)
    up, dn = _w8_np(rng, 512, 128), _w8_np(rng, 128, 512)
    upb = rng.normal(0, 0.1, 512).astype(np.float32)
    ref = np.asarray(jaq.mlp_gq_pallas(
        jnp.asarray(codes), jnp.asarray(sx[:, None]), jnp.asarray(up.c8), jnp.asarray(up.ws),
        jnp.asarray(upb), jnp.asarray(dn.c8), jnp.asarray(dn.ws), act=act, interpret=True,
        out_dtype=jnp.float32))
    t = torch.from_numpy
    out = aq.mlp_gq(t(codes), t(sx), t(up.c8), t(up.ws), t(upb), t(dn.c8), t(dn.ws), act=act,
                    out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (52, 128)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def _qkv_i8(seed, b, s, nh, dh):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (b, s, 3 * nh * dh)).astype(np.int8)
    scales = rng.uniform(0.01, 0.03, (b, s)).astype(np.float32)
    return codes, scales


@pytest.mark.parametrize("quant_out", [False, True])
@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("mode", ["plain", "causal", "valid_len"])
def test_mha_qkv_i8_matches_pallas(quant_out, dh, mode):
    """``mha_qkv_i8``'s plain version against ``mha_pallas_qkv_i8`` in
    interpret mode (flat body, B = 4, S = 50): the f32 output within 1e-4,
    or the requantized output's codes and scales."""
    b, s, nh = 4, 50, 2
    assert jat.flat_eligible(b, s, 3 * nh * dh, quant_out=quant_out)
    codes, scales = _qkv_i8(24, b, s, nh, dh)
    kw = dict(n_head=nh, scale=dh ** -0.5, causal=mode == "causal",
              valid_len=37 if mode == "valid_len" else None)
    ref = jat.mha_pallas_qkv_i8(jnp.asarray(codes), jnp.asarray(scales[..., None]),
                                interpret=True, quant_out=quant_out, out_dtype=jnp.float32,
                                **kw)
    out = at.mha_qkv_i8(torch.from_numpy(codes), torch.from_numpy(scales),
                        quant_out=quant_out, out_dtype=torch.float32, **kw)
    if quant_out:
        att = at.attention_i8_plain(torch.from_numpy(codes.reshape(b * s, -1)),
                                    torch.from_numpy(scales.reshape(-1)), b, s, nh,
                                    kw["scale"], kw["causal"], kw["valid_len"])
        _same_codes(out[0].reshape(b * s, -1), out[1], ref[0], ref[1], att, 1e-6)
    else:
        assert out.dtype == torch.float32 and out.shape == (b, s, nh * dh)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("s,dh", [(50, 64), (80, 64), (584, 64), (640, 64), (640, 80)])
def test_attention_i8_core_fits(s, dh):
    """The int8 attention core takes every single-image sequence (S <= 640)
    at d_head 64 and 80 in one block's shared memory."""
    assert at.attention_i8_smem(s, dh) <= at.SMEM_LIMIT


# -- blocks against the JAX block ------------------------------------------------

_TRACED = {aq: ("lnq", "gemm_gq", "w8a8_pre", "mlp_gq", "mlp_lnq", "gemm_i8", "requant"),
           at: ("attn_block", "attention_heads", "mha_qkv", "mha_qkv_i8")}


def _trace(monkeypatch):
    """Record which wrappers the port's block calls (in call order)."""
    calls = []
    for mod, names in _TRACED.items():
        for name in names:
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _name=name, **k):
                calls.append(_name)
                return _fn(*a, **k)

            monkeypatch.setattr(mod, name, spy)
    return calls


def _w8_pair(src):
    """A 2-D q4_0 source as (JAX W8Tensor, port W8Tensor), both keeping it."""
    jsrc = jqt.QTensor(q=src.q, d=src.d, m=src.m, qtype=int(src.qtype), hb=src.hb)
    w = jqt.to_w8tensor(jsrc, keep_source=True)
    return (jqt.W8Tensor(c8=jnp.asarray(w.c8), ws=jnp.asarray(w.ws), qtype=w.qtype, qt=w.qt),
            tqt.to_w8tensor(src, keep_source=True).to("cpu"))


def _layer_pair(layer: dict):
    """One layer of numpy leaves (2-D QTensor weights) for each side."""
    jlp, tlp = {}, {}
    for k, v in layer.items():
        if isinstance(v, tqt.QTensor):
            jlp[k], tlp[k] = _w8_pair(v)
        else:
            jlp[k], tlp[k] = jnp.asarray(v), torch.from_numpy(np.ascontiguousarray(v))
    return jlp, tlp


@pytest.fixture(scope="module")
def w128(tmp_path_factory):
    """The 128-wide q4_0 checkpoint and its text layer 0 for both sides."""
    path = _w128_q4_gguf(tmp_path_factory.mktemp("w128s"))
    with GGUFReader(path) as r:
        layers = load_params_np(r)["text"]["layers"]
    return path, _layer_pair({k: v[0] for k, v in layers.items()})


# flag set -> (B, S, flags, wrappers the port's block must call, in order)
FLAG_SETS = {
    "staged_quant_o": (4, 8, dict(attn_block=False),
                       ["lnq", "w8a8_pre", "attention_heads", "requant", "gemm_i8",
                        "mlp_lnq"]),
    "staged_bf16": (1, 6, dict(attn_block=False),
                    ["lnq", "w8a8_pre", "mha_qkv", "mlp_lnq"]),
    "mlp_staged": (4, 8, dict(mlp_full=False),
                   ["attn_block", "lnq", "gemm_gq", "gemm_i8"]),
    "up_gq": (4, 8, dict(lnq_fuse=False, up_gq=True), ["mha_qkv", "mlp_gq"]),
    "up_gq_split": (4, 8, dict(lnq_fuse=False, up_gq=True, mlp_full=False),
                    ["mha_qkv", "gemm_gq", "w8a8_pre"]),
    "no_lnq": (4, 8, dict(lnq_fuse=False), ["mha_qkv"]),
    "attn_i8": (4, 8, dict(attn_block=False, attn_i8=True),
                ["lnq", "gemm_gq", "mha_qkv_i8", "gemm_i8", "mlp_lnq"]),
    "attn_i8_bf16": (1, 6, dict(attn_block=False, attn_i8=True),
                     ["lnq", "w8a8_pre", "mha_qkv", "mlp_lnq"]),
}


@pytest.mark.parametrize("flags", list(FLAG_SETS))
@pytest.mark.parametrize("mode", ["plain", "causal", "valid_len"])
def test_block_matches_jax(w128, monkeypatch, flags, mode):
    _, (jlp, tlp) = w128
    b, s, fl, route = FLAG_SETS[flags]
    x = np.random.default_rng(30).normal(0, 1, (b, s, 128)).astype(np.float32)
    kw = dict(n_head=4, eps=EPS, use_gelu=False, causal=mode == "causal",
              valid_len=s - 2 if mode == "valid_len" else None)
    ref = np.asarray(jtr.block(jnp.asarray(x), jlp, compute_dtype=jnp.float32,
                               attn_impl="pallas", **{"lnq_fuse": True, **fl}, **kw))
    calls = _trace(monkeypatch)
    out = transformer.block(torch.from_numpy(x), tlp, **fl, **kw)
    assert calls == route
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), ref, **BLOCK_TOL)
    assert _cos(out.numpy(), ref) > 0.9999


# -- ViT-L/14-336 at full width, one layer ------------------------------------

def _q4_weight(rng, n, k):
    packed = quantize(rng.normal(0, 0.02, (n, k)).astype(np.float32), GGMLType.Q4_0)
    return tqt.from_ggml_blocks(packed, (n, k), GGMLType.Q4_0)


@pytest.fixture(scope="module")
def l14_336_layer():
    """One layer at ViT-L/14-336's widths (H 1024, MLP 4096), random q4_0
    weights."""
    rng = np.random.default_rng(40)
    h, f = 1024, 4096

    def vec(n, mean=0.0, std=0.02):
        return rng.normal(mean, std, n).astype(np.float32)

    return _layer_pair({
        "ln1_w": vec(h, 1.0, 0.1), "ln1_b": vec(h, 0.0, 0.1), "qkv_w": _q4_weight(rng, 3 * h, h),
        "qkv_b": vec(3 * h), "o_w": _q4_weight(rng, h, h), "o_b": vec(h),
        "ln2_w": vec(h, 1.0, 0.1), "ln2_b": vec(h, 0.0, 0.1), "up_w": _q4_weight(rng, f, h),
        "up_b": vec(f), "down_w": _q4_weight(rng, h, f), "down_b": vec(h)})


@pytest.mark.parametrize("b", [1, 4])
def test_l14_336_layer_matches_jax(l14_336_layer, monkeypatch, b, capsys):
    """One ViT-L/14-336-wide layer at the pad-once S = 584 (valid 577)
    against the JAX block: the port takes the staged attention route (no
    attention block) and the whole-MLP block, as the JAX package does.
    Beside it, the route difference this replaced: the fused attention
    chain at S = 577 (the port's route before it copied the gates), against
    the same reference on the 577 real rows."""
    jlp, tlp = l14_336_layer
    s, vl = 584, 577
    x = np.random.default_rng(41).normal(0, 1, (b, s, 1024)).astype(np.float32)
    x[:, vl:] = 0.0
    kw = dict(n_head=16, eps=EPS, use_gelu=False, valid_len=vl)
    ref = np.asarray(jtr.block(jnp.asarray(x), jlp, compute_dtype=jnp.float32,
                               attn_impl="pallas", lnq_fuse=True, **kw))
    calls = _trace(monkeypatch)
    out = transformer.block(torch.from_numpy(x), tlp, **kw).numpy()
    assert "attn_block" not in calls and calls[:3] == ["lnq", "w8a8_pre", "mha_qkv"], calls
    assert "mlp_lnq" in calls
    np.testing.assert_allclose(out, ref, **BLOCK_TOL)
    staged_cos, staged_err = _cos(out, ref), float(np.abs(out - ref).max())
    assert staged_cos > 0.9999

    x577 = torch.from_numpy(np.ascontiguousarray(x[:, :vl]))
    q8, o8, up, dn = (tlp[k] for k in ("qkv_w", "o_w", "up_w", "down_w"))
    fused = at.attn_block_plain(x577, tlp["ln1_w"], tlp["ln1_b"], q8.c8, q8.ws, tlp["qkv_b"],
                                o8.c8, o8.ws, tlp["o_b"], n_head=16, scale=1 / 8.0, eps=EPS)
    fused = aq.mlp_lnq_plain(fused.reshape(b * vl, -1), tlp["ln2_w"], tlp["ln2_b"], up.c8,
                             up.ws, tlp["up_b"], dn.c8, dn.ws, tlp["down_b"], eps=EPS)
    fused = fused.reshape(b, vl, -1).numpy()
    fused_cos, fused_err = _cos(fused, ref[:, :vl]), float(np.abs(fused - ref[:, :vl]).max())
    delta_cos = _cos(fused - x[:, :vl], ref[:, :vl] - x[:, :vl])
    assert np.isfinite(fused).all() and fused_cos > 0.999
    with capsys.disabled():
        print(f"\nL/14-336 layer B={b}: staged port vs JAX cos {staged_cos:.7f} max err "
              f"{staged_err:.3g}; fused S=577 chain vs JAX cos {fused_cos:.7f} max err "
              f"{fused_err:.3g}, layer delta (output - x) cos {delta_cos:.7f}")


# -- small-row route, device preprocessing, engine, parameters ---------------

@pytest.mark.parametrize("rows", [1, 584, 2048, 2049])
def test_source_route_matches_jax(rows, monkeypatch):
    """The port sends a W8Tensor GEMM to its kept source exactly where the
    JAX package on a TPU sends it to ``qmatmul_pallas`` on the source."""
    import importlib

    L = importlib.import_module("clip_tpu.ops.linear")
    Q = importlib.import_module("clip_tpu.ops.qmatmul_pallas")
    rng = np.random.default_rng(42)
    src = _q4_weight(rng, 32, 64)
    jsrc = jqt.QTensor(q=src.q, d=src.d, m=src.m, qtype=int(src.qtype), hb=src.hb)
    taken = []
    monkeypatch.setattr(L.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(Q, "qmatmul_pallas", lambda x, w, **k: taken.append(w) or x[..., :32])
    for keep in (True, False):
        taken.clear()
        jw = jqt.to_w8tensor(jsrc, keep_source=keep)
        L.qmatmul(jnp.zeros((rows, 64), jnp.float32), jw)
        tw = tqt.to_w8tensor(src, keep_source=keep)
        assert linear.source_route(tw, rows) == bool(taken)


@pytest.mark.parametrize("m", [1, 3, 584])
def test_small_row_source_matches_pallas(m):
    """The small-row o projection on the kept q4_0 source (``qmatmul_plain``
    on ``W8Tensor.qt``) against ``qmatmul_pallas`` in interpret mode, the
    route the JAX package takes on a TPU and never on the CPU."""
    rng = np.random.default_rng(43)
    jw, tw = _w8_pair(_q4_weight(rng, 256, 128))
    x = rng.normal(0, 1, (m, 128)).astype(np.float32)
    ref = np.asarray(qmatmul_pallas(jnp.asarray(x), jw.qt, compute_dtype=jnp.float32,
                                    interpret=True))
    out = qmatmul_plain(torch.from_numpy(x), tw.qt)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_device_preprocess_matches_jax_and_host():
    imgs = np.random.default_rng(44).integers(0, 256, (3, 97, 131, 3), dtype=np.uint8)
    host = jax_preprocess_batch(list(imgs), 64, MEAN, STD)
    ref = np.asarray(jax_device_preprocess(imgs, 64, MEAN, STD))
    out = device_preprocess(imgs, 64, MEAN, STD).numpy()
    assert out.shape == host.shape == (3, 64, 64, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, host, atol=5e-4)
    np.testing.assert_allclose(out, ref, atol=5e-4)


@pytest.fixture(scope="module")
def engines_no_lnq(w128):
    path, _ = w128
    ref = JaxEngine(path, verbosity=0, act_quant=True, lnq_fuse=False, attn_impl="pallas",
                    compute_dtype="float32")
    port = ClipEngine(path, device="cpu", lnq_fuse=False, verbosity=0)
    yield ref, port
    ref.close()
    port.close()


def test_engine_without_lnq_matches_jax(engines_no_lnq):
    """``ClipEngine(lnq_fuse=False)`` against the JAX engine with the same
    flags: both towers take the no-lnq attention and the LN + linear MLP on
    the CPU (neither engine turns on ``up_gq`` off the accelerator)."""
    ref, port = engines_no_lnq
    assert not port.lnq_fuse and not port._upgq_active
    texts = ["tok1 tok2", "tok5 tok6 tok7"]
    a, b = port.encode_text(texts), ref.encode_text(texts)
    assert ((a * b).sum(1) > 0.9999).all()
    rng = np.random.default_rng(45)
    imgs = [(rng.random((40, 36, 3)) * 255).astype(np.uint8) for _ in range(3)]
    a, b = port.encode_image(imgs), ref.encode_image(imgs)
    assert ((a * b).sum(1) > 0.9999).all(), (a * b).sum(1)


def test_engine_device_preprocess_matches_jax(engines_no_lnq):
    """uint8 images of one shape go through device preprocessing in both
    engines and agree with each other and with the host path."""
    ref, port = engines_no_lnq
    rng = np.random.default_rng(46)
    imgs = [(rng.random((50, 60, 3)) * 255).astype(np.uint8) for _ in range(2)]
    dev = port.encode_image(imgs)
    host = port.encode_image(imgs, device_preprocess=False)
    want = ref.encode_image(imgs, device_preprocess=True)
    assert ((dev * want).sum(1) > 0.9999).all()
    np.testing.assert_allclose(dev, host, atol=2e-4)
    assert port.encode_image(imgs[0]).shape == (port.projection_dim,)


def test_params_from_numpy_keeps_the_source(engines_no_lnq):
    ref, port = engines_no_lnq
    conv = params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu", torch.float32)
    for tower in ("text", "vision"):
        for name in ("qkv_w", "o_w", "up_w", "down_w"):
            a, b = conv[tower]["layers"][name], port.params[tower]["layers"][name]
            assert a.qt is not None and b.qt is not None
            assert torch.equal(a.qt.q, b.qt.q) and torch.equal(a.qt.d, b.qt.d)
            assert a.qt.qtype == b.qt.qtype == GGMLType.Q4_0
            assert torch.equal(a[0].qt.q, b.qt.q[0])
