"""The port's weight-streaming W8A8 routes and its last three kernels against
the JAX package, on the CPU.

* The copied gates and plans (``_ablk_stream_plan``,
  ``attn_block_stream_fusable``, ``_mlp_stream_plan``, ``mlp_stream_fusable``,
  ``layer_block_fusable``) equal the JAX functions on a grid of batches and
  every catalog width, plus ViT-B/16 at 384 px (768 wide, S 584) and
  ViT-H/14 at 252 and 280 px (1280 wide, S 328 and 408).
* The plain versions (a CPU tensor takes the plain version in every
  wrapper) of ``attn_block_stream`` (row 8), ``mlp_lnq_stream`` (row 9),
  ``actq`` (row 11), ``layer_block`` (row 12) and ``mha`` (row 13) against
  the Pallas kernels in interpret mode.  In float32: within 1e-4 and cos >
  0.9999; int8 codes equal but for 1 at rounding ties, scales within 1e-6
  (``tests/test_actquant_fusion.py:56-58``).  In bf16 (``mha``): within 2
  bf16 ulps and cos > 0.9999.  Where the JAX tests assert ``array_equal``
  (the streamed MLP with ``exact=True``, or with one chunk, against the
  resident block: ``tests/test_actquant_fusion.py:642-690``) the port's
  versions are bit-equal too.
* The routes: one ViT-B/16-384-wide layer (S 584, valid 577) takes row 8
  and one ViT-H/14-wide layer with ``mlp_stream=True`` takes row 9, each
  against the JAX ``block`` within its bound (``tests/test_actquant_fusion
  .py:347-351``: 5e-2 and cos > 0.9999); the second is bit-equal to the
  port's default staged route.
* The slice: a q4_0 ViT-B/16 vision tower at 384 px cut to 2 layers, the
  port's engine on the CPU against the JAX engine, image-embedding cos >
  0.9999.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_tpu import synth as jax_synth
from clip_tpu.engine import ClipEngine as JaxEngine
from clip_tpu.models import transformer as jtr
from clip_tpu.ops import actquant_pallas as jaq
from clip_tpu.ops import attention_pallas as jat

from clip_tpu_torch import synth
from clip_tpu_torch.engine import ClipEngine
from clip_tpu_torch.models import transformer
from clip_tpu_torch.ops import actquant as aq
from clip_tpu_torch.ops import attention as at
from clip_tpu_torch.ops import qtensor as tqt
from clip_tpu_torch.ops.nn import layernorm_f32
from test_torch_staged import BLOCK_TOL, _cos, _layer_pair, _q4_weight

EPS = 1e-5
BATCHES = (1, 2, 3, 4, 8, 16, 64, 256)


# -- gates and plans ----------------------------------------------------------

def _geometries():
    """(label, h, n_head, mlp, sequences) for every tower of the catalog
    (its S, padded to a multiple of 8, and the text tower's 80), plus the
    geometries that reach the streamed attention block."""
    out = []
    for name, v in jax_synth.VARIANTS.items():
        s = (v.image_size // v.patch_size) ** 2 + 1
        out.append((f"{name}-vision", v.v_hidden, v.v_heads, v.v_ff, (s, -(-s // 8) * 8)))
        out.append((f"{name}-text", v.t_hidden, v.t_heads, v.t_ff, (77, 80)))
    out.append(("B16-384", 768, 12, 3072, (577, 584)))
    out.append(("H14-252-280", 1280, 16, 5120, (325, 328, 401, 408)))
    return out


@pytest.mark.parametrize("label,h,n_head,mlp,seqs", _geometries(),
                         ids=[g[0] for g in _geometries()])
def test_stream_gates_match_jax(label, h, n_head, mlp, seqs):
    dh = h // n_head
    assert aq.mlp_stream_fusable(h, mlp) == jaq.mlp_stream_fusable(h, mlp)
    for b in BATCHES:
        for s in seqs:
            assert (at.attn_block_stream_fusable(h, 3 * h, h, b, s, n_head=n_head)
                    == jat.attn_block_stream_fusable(h, 3 * h, h, b, s, n_head=n_head))
            assert (at.layer_block_fusable(h, 3 * h, h, mlp, b, s)
                    == jat.layer_block_fusable(h, 3 * h, h, mlp, b, s))
            bb = at._flat_block_b(b, s, 3 * h)
            for rt in {b * s, (bb or 1) * s}:
                assert (at._ablk_stream_plan(rt, h, 3 * h, h, dh)
                        == jat._ablk_stream_plan(rt, h, 3 * h, h, dh))
                assert aq._mlp_stream_plan(rt, h, mlp) == jaq._mlp_stream_plan(rt, h, mlp)


def test_stream_geometries():
    """Where the streamed routes are taken, and with which groups: the
    ViT-B/16-384 tower at every batch (hg 4, three groups of 256 columns),
    ViT-H/14 at 252 or 280 px (hg 8: groups of 640 columns at d_head 80),
    and the streamed MLP at ViT-H/14's widths (8 chunks of 640)."""
    for b in BATCHES:
        assert at.flat_eligible(b, 584, 2304) and not at.flat_eligible(b, 577, 2304)
        assert not at.attn_block_fusable(768, 2304, 768, b, 584)
        assert at.attn_block_stream_fusable(768, 2304, 768, b, 584, n_head=12)
        assert at.stream_heads(b, 584, 768, 2304, 768, 12) == 4
    for s in (328, 408):
        assert at.attn_block_stream_fusable(1280, 3840, 1280, 2, s, n_head=16)
        assert at.stream_heads(2, s, 1280, 3840, 1280, 16) == 8
    assert not aq.mlp_fusable(1280, 5120) and aq.mlp_stream_fusable(1280, 5120)
    assert aq._mlp_stream_plan(64 * 264, 1280, 5120) == (256, 8)


# -- kernels: plain versions against the JAX kernels ---------------------------

def _w8(rng, n, k):
    return tqt.to_w8tensor(rng.normal(0, 0.05, (n, k)).astype(np.float32))


def _vec(rng, n, mean=0.0, std=0.05):
    return rng.normal(mean, std, n).astype(np.float32)


def _close(out, ref, atol=1e-4):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    assert _cos(out, ref) > 0.9999


def _ties(y, scales):
    """Per row of ``y [rows, N]``: the elements whose ``y / scale`` (scales
    ``[rows]`` or ``[rows, groups]``) lies within 1e-3 of a rounding tie,
    where the two sides' codes may differ by 1."""
    sc = scales.double().reshape(y.shape[0], -1)
    v = y.double() / sc.repeat_interleave(y.shape[1] // sc.shape[1], 1)
    return ((v - v.floor() - 0.5).abs() < 1e-3).sum(1).numpy()


def _close_rows(out, ref, allow):
    """``out`` against ``ref`` within 1e-4 + ``allow[r]`` on each row, and
    cos > 0.9999 over all."""
    out = np.asarray(out, np.float32).reshape(len(allow), -1)
    ref = np.asarray(ref, np.float32).reshape(out.shape)
    err = np.abs(out - ref).max(1)
    assert (err <= 1e-4 + allow).all(), (err.max(), err[allow == 0].max(initial=0.0))
    assert _cos(out, ref) > 0.9999


def _code_step(w8, ws, scales):
    """Per row: what one input code moves an output by, ``max |w8 * ws| *
    scale``."""
    wmax = float((w8.double().abs() * ws.double()[:, None]).max())
    return wmax * scales.double().reshape(scales.shape[0], -1).max(1).values.numpy()


def _same_codes(codes, scales, rc, rs, y):
    """Row-quant outputs against the JAX ones: scales within 1e-6, codes
    equal except by 1 where ``y / scale`` sits at a rounding tie."""
    codes, rc = np.asarray(codes, np.int32), np.asarray(rc, np.int32).reshape(codes.shape)
    rs = np.asarray(rs).reshape(-1)
    np.testing.assert_allclose(np.asarray(scales).reshape(-1), rs, rtol=1e-6, atol=0)
    diff = np.abs(codes - rc)
    assert diff.max() <= 1
    if diff.max():
        v = np.asarray(y, np.float64) / rs[:, None]
        assert np.abs(v - np.floor(v) - 0.5)[diff > 0].max() < 1e-3


@pytest.fixture(scope="module")
def attn_weights():
    rng = np.random.default_rng(50)
    h = 256
    return dict(lnw=_vec(rng, h, 1.0, 0.1), lnb=_vec(rng, h, 0.0, 0.1), qw=_w8(rng, 3 * h, h),
                qb=_vec(rng, 3 * h), ow=_w8(rng, h, h), ob=_vec(rng, h))


@pytest.mark.parametrize("s", [8, 16])
@pytest.mark.parametrize("mode", ["plain", "causal", "valid_len"])
@pytest.mark.parametrize("epilogue", ["pre_bias", "bias", "residual"])
def test_attn_block_stream_matches_pallas(attn_weights, s, mode, epilogue):
    """Row 8 at h 256, 4 heads, B 3, head groups of 2 (two groups of 128
    columns), in float32."""
    wt = attn_weights
    b, h = 3, 256
    x = np.random.default_rng(51).normal(0, 1, (b, s, h)).astype(np.float32)
    ob = None if epilogue == "pre_bias" else wt["ob"]
    kw = dict(n_head=4, scale=0.125, eps=EPS, causal=mode == "causal",
              valid_len=s - 3 if mode == "valid_len" else None,
              residual=epilogue == "residual")
    ref = jat.attn_block_stream_pallas(
        jnp.asarray(x), *(jnp.asarray(a) for a in (wt["lnw"], wt["lnb"], wt["qw"].c8,
                                                   wt["qw"].ws, wt["qb"], wt["ow"].c8,
                                                   wt["ow"].ws)),
        None if ob is None else jnp.asarray(ob), interpret=True, out_dtype=jnp.float32,
        cq=3, hg=2, **kw)
    t = torch.from_numpy
    out = at.attn_block_stream(t(x), t(wt["lnw"]), t(wt["lnb"]), t(wt["qw"].c8),
                               t(wt["qw"].ws), t(wt["qb"]), t(wt["ow"].c8), t(wt["ow"].ws),
                               None if ob is None else t(ob), hg=2, **kw)
    assert out.dtype == torch.float32 and out.shape == (b, s, h)
    # the attention output the o GEMM quantizes, per head group of 128
    x2 = t(x).reshape(b * s, h)
    c1, s1 = aq.lnq_plain(x2, t(wt["lnw"]), t(wt["lnb"]), EPS)
    qkv = aq.gemm_i8_plain(c1, t(wt["qw"].c8), s1, t(wt["qw"].ws), t(wt["qb"]), aq.BIAS,
                           out_dtype=torch.float32)
    att = at.attention_heads_plain(qkv, b, s, 4, 0.125, kw["causal"], kw["valid_len"])
    s2 = aq.requant_plain(att, group=128)[1]
    _close_rows(out, ref, _ties(att, s2) * _code_step(t(wt["ow"].c8), t(wt["ow"].ws), s2))


def test_attn_block_stream_one_group_is_the_resident_block(attn_weights):
    """With one head group (hg = n_head) the streamed block quantizes the
    attention output over the full row: the resident block's function."""
    wt = attn_weights
    x = torch.from_numpy(np.random.default_rng(52).normal(0, 1, (3, 8, 256)).astype(np.float32))
    args = [torch.from_numpy(a) for a in (wt["lnw"], wt["lnb"], wt["qw"].c8, wt["qw"].ws,
                                          wt["qb"], wt["ow"].c8, wt["ow"].ws, wt["ob"])]
    kw = dict(n_head=4, scale=0.125, eps=EPS)
    one = at.attn_block_stream(x, *args, hg=4, residual=True, **kw)
    assert torch.equal(one, at.attn_block(x, *args, **kw))


@pytest.fixture(scope="module")
def mlp_weights():
    rng = np.random.default_rng(53)
    h, f = 128, 512
    return dict(x=rng.normal(0, 1, (52, h)).astype(np.float32), lnw=_vec(rng, h, 1.0, 0.05),
                lnb=_vec(rng, h), up=_w8(rng, f, h), dn=_w8(rng, h, f), upb=_vec(rng, f),
                dnb=_vec(rng, h))


def _mlp_args(wt, lib):
    cast = jnp.asarray if lib == "jax" else torch.from_numpy
    return [cast(a) for a in (wt["x"], wt["lnw"], wt["lnb"], wt["up"].c8, wt["up"].ws,
                              wt["upb"], wt["dn"].c8, wt["dn"].ws)]


@pytest.mark.parametrize("act", ["gelu_quick", "gelu_tanh"])
@pytest.mark.parametrize("chunks", [None, 1, 2, 4])
@pytest.mark.parametrize("epilogue", ["pre_bias", "residual"])
def test_mlp_lnq_stream_matches_pallas(mlp_weights, act, chunks, epilogue):
    """Row 9 at h 128, f 512 over 52 rows in float32: ``exact=True``
    (``chunks`` None) and ``exact=False`` with 1, 2 and 4 chunks of 4H."""
    wt = mlp_weights
    exact = chunks is None
    res = epilogue == "residual"
    kw = dict(eps=EPS, act=act, residual=res, exact=exact, n_chunks=chunks)
    ref = jaq.mlp_lnq_stream_pallas(*_mlp_args(wt, "jax"), jnp.asarray(wt["dnb"]) if res else None,
                                    interpret=True, out_dtype=jnp.float32, **kw)
    out = aq.mlp_lnq_stream(*_mlp_args(wt, "torch"), torch.from_numpy(wt["dnb"]) if res else None,
                            **kw)
    assert out.dtype == torch.float32 and out.shape == (52, 128)
    _close(out, ref)
    if res and (exact or chunks == 1):
        # the resident block's function, bit for bit (as the JAX test asserts
        # of its kernels)
        args = _mlp_args(wt, "torch")
        want = aq.mlp_lnq(*args, torch.from_numpy(wt["dnb"]), eps=EPS, act=act)
        assert torch.equal(out, want)


def test_grouped_epilogue_one_group_is_the_residual_epilogue(mlp_weights):
    """The grouped GEMM epilogue with one group equals the residual one."""
    rng = np.random.default_rng(54)
    a = torch.from_numpy(rng.integers(-127, 128, (37, 512), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (128, 512), dtype=np.int8))
    sx = torch.from_numpy(rng.uniform(0.005, 0.05, 37).astype(np.float32))
    ws, bias = torch.from_numpy(_vec(rng, 128, 0.01, 0.001)), torch.from_numpy(_vec(rng, 128))
    x = torch.from_numpy(rng.normal(0, 1, (37, 128)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        want = aq.gemm_i8(a, b, sx, ws, bias, aq.RESID, resid=x.to(dt), out_dtype=dt)
        got = aq.gemm_i8(a, b, sx[:, None], ws, bias, aq.GROUPED, resid=x.to(dt), out_dtype=dt,
                         group=512)
        assert torch.equal(got, want)


@pytest.mark.parametrize("act", ["gelu_quick", "gelu_tanh", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_actq_matches_pallas(act, dtype):
    """Row 11 over [70, 384] (the JAX test's shape) in f32 and bf16."""
    x = np.random.default_rng(55).normal(0, 2.0, (70, 384)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    rc, rs = jaq.actq_pallas(jx, act=act, block_rows=16, interpret=True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    codes, sx = aq.actq(tx, act)
    assert codes.dtype == torch.int8 and sx.shape == (70,)
    _same_codes(codes, sx, rc, rs, aq.act_f32(tx, act))


def test_grouped_requant_is_a_row_requant_per_group():
    y = torch.from_numpy(np.random.default_rng(56).normal(0, 1, (9, 768)).astype(np.float32))
    codes, sx = aq.requant(y, group=256)
    assert codes.shape == (9, 768) and sx.shape == (9, 3)
    for g in range(3):
        c, s = aq.requant(y[:, g * 256:(g + 1) * 256].contiguous())
        assert torch.equal(codes[:, g * 256:(g + 1) * 256], c) and torch.equal(sx[:, g], s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,nh,causal", [(3, 13, 128, 2, False), (2, 77, 128, 2, True),
                                             (1, 50, 256, 4, False)])
def test_mha_matches_pallas(dtype, b, s, h, nh, causal):
    """Row 13: separate q, k, v in f32 or bf16, S not a multiple of 8 (the
    TPU kernel pads and masks the pad keys)."""
    rng = np.random.default_rng(57)
    qkv = [jnp.asarray(rng.normal(size=(b, s, h)).astype(np.float32), getattr(jnp, dtype))
           for _ in range(3)]
    kw = dict(n_head=nh, scale=(h // nh) ** -0.5, causal=causal)
    ref = np.asarray(jat.mha_pallas(*qkv, interpret=True, **kw).astype(jnp.float32))
    tq = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
          for a in qkv]
    out = at.mha(*tq, **kw)
    assert out.dtype == getattr(torch, dtype) and out.shape == (b, s, h)
    if dtype == "float32":
        _close(out, ref)
    else:
        out = out.float().numpy()
        np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=2 ** -7)
        assert _cos(out, ref) > 0.9999


@pytest.mark.parametrize("causal", [False, True])
def test_layer_block_matches_pallas(causal):
    """Row 12 at (128, 512, 2 heads, B 3, S 8) in float32 against
    ``layer_block_pallas``, and equal to its two blocks.  A row whose int8
    inputs hold a rounding tie at any of the layer's four row quants (where
    the two sides' codes may differ by 1, and the difference runs on
    through the layer) is held to the JAX test's layer bound, 5e-2
    (``tests/test_actquant_fusion.py:637``); every other row to 1e-4."""
    rng = np.random.default_rng(58)
    h, f, nh, b, s = 128, 512, 2, 3, 8
    assert at.layer_block_fusable(h, 3 * h, h, f, b, s)
    x = rng.normal(0, 1, (b, s, h)).astype(np.float32)
    qw, ow, up, dn = _w8(rng, 3 * h, h), _w8(rng, h, h), _w8(rng, f, h), _w8(rng, h, f)
    vals = [_vec(rng, h, 1.0), _vec(rng, h), qw.c8, qw.ws, _vec(rng, 3 * h), ow.c8, ow.ws,
            _vec(rng, h), _vec(rng, h, 1.0), _vec(rng, h), up.c8, up.ws, _vec(rng, f), dn.c8,
            dn.ws, _vec(rng, h)]
    kw = dict(n_head=nh, scale=0.125, eps=EPS, act="gelu_quick", causal=causal)
    ref = jat.layer_block_pallas(jnp.asarray(x), *(jnp.asarray(v) for v in vals),
                                 interpret=True, out_dtype=jnp.float32, **kw)
    tv = [torch.from_numpy(v) for v in vals]
    out = at.layer_block(torch.from_numpy(x), *tv, **kw)
    assert out.dtype == torch.float32 and out.shape == (b, s, h)
    akw = {k: v for k, v in kw.items() if k != "act"}
    xm = at.attn_block(torch.from_numpy(x), *tv[:8], **akw).reshape(b * s, h)
    two = aq.mlp_lnq(xm, *tv[8:], eps=EPS, act="gelu_quick").reshape(b, s, h)
    assert torch.equal(out, two)
    # the layer's four row quants, on the port's side
    ties = np.zeros(b * s, int)
    for xin, lw, lb, w8, ws, bias, mode in (
            (torch.from_numpy(x).reshape(b * s, h), *tv[0:2], *tv[2:5], aq.BIAS),
            (xm, *tv[8:10], *tv[10:13], aq.GELU_QUICK)):
        c, sx = aq.lnq_plain(xin, lw, lb, EPS)
        ties += _ties(layernorm_f32(xin, lw, lb, EPS), sx)
        y = aq.gemm_i8_plain(c, w8, sx, ws, bias, mode, out_dtype=torch.float32)
        if mode == aq.BIAS:
            y = at.attention_heads_plain(y, b, s, nh, 0.125, causal)
        ties += _ties(y, aq.requant_plain(y)[1])
    _close_rows(out, ref, np.where(ties > 0, 5e-2, 0.0))


# -- the routes -----------------------------------------------------------------

_TRACED = {aq: ("lnq", "gemm_gq", "w8a8_pre", "mlp_gq", "mlp_lnq", "mlp_lnq_stream", "gemm_i8",
                "requant"),
           at: ("attn_block", "attn_block_stream", "attention_heads", "mha_qkv", "mha_qkv_i8")}


def _trace(monkeypatch):
    """Record which wrappers the port's block calls (in call order)."""
    calls = []
    for mod, names in _TRACED.items():
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k:
                                calls.append(_n) or _fn(*a, **k))
    return calls


def _layer(seed, h, f):
    """One layer of random q4_0 weights at width ``h`` and MLP ``f``."""
    rng = np.random.default_rng(seed)

    def vec(n, mean=0.0, std=0.02):
        return rng.normal(mean, std, n).astype(np.float32)

    return _layer_pair({
        "ln1_w": vec(h, 1.0, 0.1), "ln1_b": vec(h, 0.0, 0.1), "qkv_w": _q4_weight(rng, 3 * h, h),
        "qkv_b": vec(3 * h), "o_w": _q4_weight(rng, h, h), "o_b": vec(h),
        "ln2_w": vec(h, 1.0, 0.1), "ln2_b": vec(h, 0.0, 0.1), "up_w": _q4_weight(rng, f, h),
        "up_b": vec(f), "down_w": _q4_weight(rng, h, f), "down_b": vec(h)})


def test_b16_384_layer_takes_the_streamed_block(monkeypatch):
    """One ViT-B/16-384-wide layer (H 768, 12 heads, MLP 3072) at the
    pad-once S = 584 (valid 577), B = 1: the streamed attention block and
    the whole-MLP block, as the JAX package takes them."""
    jlp, tlp = _layer(60, 768, 3072)
    s, vl = 584, 577
    x = np.random.default_rng(61).normal(0, 1, (1, s, 768)).astype(np.float32)
    x[:, vl:] = 0.0
    kw = dict(n_head=12, eps=EPS, use_gelu=False, valid_len=vl)
    ref = np.asarray(jtr.block(jnp.asarray(x), jlp, compute_dtype=jnp.float32,
                               attn_impl="pallas", lnq_fuse=True, **kw))
    calls = _trace(monkeypatch)
    out = transformer.block(torch.from_numpy(x), tlp, **kw).numpy()
    assert calls == ["attn_block_stream", "mlp_lnq"], calls
    np.testing.assert_allclose(out[:, :vl], ref[:, :vl], **BLOCK_TOL)
    assert _cos(out[:, :vl], ref[:, :vl]) > 0.9999


def test_h14_layer_mlp_stream(monkeypatch):
    """One ViT-H/14-wide layer (H 1280, 16 heads, MLP 5120) with
    ``mlp_stream=True``, B = 2, S = 8: the streamed MLP, against the JAX
    block, and bit-equal to the port's default (staged) MLP route."""
    jlp, tlp = _layer(62, 1280, 5120)
    x = np.random.default_rng(63).normal(0, 1, (2, 8, 1280)).astype(np.float32)
    kw = dict(n_head=16, eps=EPS, use_gelu=False)
    ref = np.asarray(jtr.block(jnp.asarray(x), jlp, compute_dtype=jnp.float32,
                               attn_impl="pallas", lnq_fuse=True, mlp_stream=True, **kw))
    calls = _trace(monkeypatch)
    out = transformer.block(torch.from_numpy(x), tlp, mlp_stream=True, **kw)
    assert calls[0] == "attn_block" and "mlp_lnq_stream" in calls, calls
    assert "gemm_gq" not in calls
    np.testing.assert_allclose(out.numpy(), ref, **BLOCK_TOL)
    assert _cos(out.numpy(), ref) > 0.9999
    calls.clear()
    default = transformer.block(torch.from_numpy(x), tlp, **kw)
    assert "gemm_gq" in calls and "mlp_lnq_stream" not in calls
    assert torch.equal(out, default)


@pytest.fixture(scope="module")
def b16_384_engines(tmp_path_factory):
    """A q4_0 ViT-B/16 vision tower at 384 px cut to 2 layers, written from
    seed 0, in both engines."""
    mp = pytest.MonkeyPatch()
    name = "ViT-B/16-384-cut2"
    for pkg in (synth, jax_synth):
        mp.setitem(pkg.VARIANTS, name, dataclasses.replace(pkg.VARIANTS["ViT-B/16"],
                                                           image_size=384, v_layers=2))
    path = synth.make_synthetic_gguf(str(tmp_path_factory.mktemp("b16_384") / "m.gguf"), name,
                                     ftype="q4_0", towers="vision", seed=0)
    ref = JaxEngine(path, verbosity=0, act_quant=True, lnq_fuse=True, attn_impl="pallas",
                    compute_dtype="float32")
    port = ClipEngine(path, device="cpu", verbosity=0)
    yield ref, port
    ref.close()
    port.close()
    mp.undo()


def test_b16_384_engine_matches_jax(b16_384_engines, monkeypatch):
    """The slice end to end: two images through both engines (S 577 padded
    once to 584, every layer on the streamed attention block)."""
    ref, port = b16_384_engines
    assert port.config.vision.image_size == 384 and port.config.vision.n_layer == 2
    rng = np.random.default_rng(64)
    imgs = [(rng.random((400, 420, 3)) * 255).astype(np.uint8) for _ in range(2)]
    pixels = port.preprocess(imgs)
    calls = _trace(monkeypatch)
    a = port.encode_image(pixels)
    assert calls.count("attn_block_stream") == 2 and calls.count("mlp_lnq") == 2
    b = ref.encode_image(pixels)
    assert a.shape == b.shape == (2, 512)
    row_cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert row_cos.min() > 0.9999, row_cos
