"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: every test takes the ``card`` fixture, which skips where no
CUDA device is present (so these skip on a CPU-only host).  On a card run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because the suite's conftest imports JAX, which the card's
host need not have; this file imports only torch and the port).  Shapes are
small and ragged: row counts that fill no tile, odd sequence lengths.
"""

import numpy as np
import pytest
import torch

from clip_tpu_torch.gguf.constants import GGMLType
from clip_tpu_torch.ops import actquant as aq
from clip_tpu_torch.ops import attention as at
from clip_tpu_torch.ops.qmatmul import qmatmul_plain, qmatmul_q4, qmatmul_q5, qmatmul_q8
from clip_tpu_torch.ops.qtensor import from_ggml_blocks, to_w8tensor
from clip_tpu_torch.quant import quantize

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clip_tpu_torch.ops import _cuda

    _cuda.lib()
    return torch.device("cuda", torch.cuda.current_device())


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _w8(rng, n, k, dev):
    w = to_w8tensor(rng.normal(0, 0.05, (n, k)).astype(np.float32)).to(dev)
    return w.c8, w.ws


def _vec(rng, n, dev, mean=0.0, std=0.05):
    return torch.from_numpy(rng.normal(mean, std, n).astype(np.float32)).to(dev)


def _x(rng, shape, dev):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev).bfloat16()


def test_lnq_matches_plain(card):
    rng = np.random.default_rng(0)
    x = _x(rng, (37, 192), card)
    w, b = _vec(rng, 192, card, 1.0, 0.1), _vec(rng, 192, card)
    codes, sx = aq.lnq(x, w, b, 1e-5)
    pc, psx = aq.lnq_plain(x, w, b, 1e-5)
    torch.testing.assert_close(sx, psx, rtol=1e-6, atol=0)
    assert int((codes.int() - pc.int()).abs().max()) <= 1


@pytest.mark.parametrize("mode", [aq.ACC, aq.BIAS, aq.RESID, aq.PRE, aq.BIAS_F32])
def test_gemm_i8_exact(card, mode):
    rng = np.random.default_rng(1)
    m, k, n = 133, 192, 136  # M fills no 128-row tile, N no 128-column tile
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(card)
    b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(card)
    sx, ws, bias = _vec(rng, m, card, 0.01, 0.001), _vec(rng, n, card, 0.01, 0.001), _vec(rng, n, card)
    resid = _x(rng, (m, n), card) if mode == aq.RESID else None
    got = aq.gemm_i8(a, b, sx, ws, bias, mode, resid=resid)
    assert torch.equal(got, aq.gemm_i8_plain(a, b, sx, ws, bias, mode, resid=resid))


@pytest.mark.parametrize("mode", [aq.GELU_QUICK, aq.GELU_TANH])
def test_gemm_i8_gelu(card, mode):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-127, 128, (70, 128), dtype=np.int8)).to(card)
    b = torch.from_numpy(rng.integers(-127, 128, (256, 128), dtype=np.int8)).to(card)
    sx, ws, bias = _vec(rng, 70, card, 0.01, 0.001), _vec(rng, 256, card, 0.001, 1e-4), _vec(rng, 256, card)
    got = aq.gemm_i8(a, b, sx, ws, bias, mode)
    torch.testing.assert_close(got, aq.gemm_i8_plain(a, b, sx, ws, bias, mode),
                               rtol=1e-5, atol=1e-6)


def test_requant_matches_plain(card):
    y = torch.from_numpy(np.random.default_rng(3).normal(0, 2, (45, 512)).astype(np.float32)).to(card)
    codes, sx = aq.requant(y)
    pc, psx = aq.requant_plain(y)
    torch.testing.assert_close(sx, psx, rtol=1e-6, atol=0)
    assert int((codes.int() - pc.int()).abs().max()) <= 1


@pytest.mark.parametrize("mode", ["plain", "causal", "valid_len"])
def test_attn_block_matches_plain(card, mode):
    rng = np.random.default_rng(4)
    b, s, h, nh = 3, 13, 128, 4
    qw8, qws = _w8(rng, 3 * h, h, card)
    ow8, ows = _w8(rng, h, h, card)
    args = (_x(rng, (b, s, h), card), _vec(rng, h, card, 1.0, 0.1), _vec(rng, h, card),
            qw8, qws, _vec(rng, 3 * h, card), ow8, ows, _vec(rng, h, card))
    kw = dict(n_head=nh, scale=1.0 / (h // nh) ** 0.5, eps=1e-5, causal=mode == "causal",
              valid_len=9 if mode == "valid_len" else None)
    out = at.attn_block(*args, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, h)
    assert _cos(out, at.attn_block_plain(*args, **kw)) > 0.999


@pytest.mark.parametrize("act", ["gelu_quick", "gelu_tanh"])
def test_mlp_lnq_matches_plain(card, act):
    rng = np.random.default_rng(5)
    h, f = 128, 512
    up8, upws = _w8(rng, f, h, card)
    dn8, dnws = _w8(rng, h, f, card)
    args = (_x(rng, (77, h), card), _vec(rng, h, card, 1.0, 0.1), _vec(rng, h, card),
            up8, upws, _vec(rng, f, card), dn8, dnws, _vec(rng, h, card))
    out = aq.mlp_lnq(*args, eps=1e-5, act=act)
    assert _cos(out, aq.mlp_lnq_plain(*args, eps=1e-5, act=act)) > 0.999


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q4_1])
def test_qmatmul_q4_matches_plain(card, qtype):
    rng = np.random.default_rng(6)
    n, k = 200, 96
    w = from_ggml_blocks(quantize(rng.normal(0, 0.05, (n, k)).astype(np.float32), qtype),
                         (n, k), qtype).to(card)
    x = _x(rng, (13, k), card)
    torch.testing.assert_close(qmatmul_q4(x, w).float(), qmatmul_plain(x, w).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("qtype,fn", [(GGMLType.Q5_0, qmatmul_q5), (GGMLType.Q5_1, qmatmul_q5),
                                      (GGMLType.Q8_0, qmatmul_q8)])
@pytest.mark.parametrize("m", [1, 13])
def test_qmatmul_q5_q8_match_plain(card, qtype, fn, m):
    rng = np.random.default_rng(9)
    n, k = 200, 96
    w = from_ggml_blocks(quantize(rng.normal(0, 0.05, (n, k)).astype(np.float32), qtype),
                         (n, k), qtype).to(card)
    x = _x(rng, (m, k), card)
    torch.testing.assert_close(fn(x, w).float(), qmatmul_plain(x, w).float(),
                               rtol=2e-2, atol=2e-2)


def test_projection_routes_by_format_and_rows(card):
    """q5 takes its kernel at any row count; q8_0 only at 2048 rows or
    fewer (``ops/linear.py``, as the JAX package routes on a TPU)."""
    from clip_tpu_torch import ops
    from clip_tpu_torch.ops.linear import qmatmul

    rng = np.random.default_rng(10)
    ws = {qt: from_ggml_blocks(quantize(rng.normal(0, 0.05, (64, 64)).astype(np.float32), qt),
                               (64, 64), qt).to(card) for qt in (GGMLType.Q5_1, GGMLType.Q8_0)}
    ops.reset_launches()
    for rows in (2048, 2049):
        x = _x(rng, (rows, 64), card)
        for w in ws.values():
            y = qmatmul(x, w)
            torch.testing.assert_close(y.float(), qmatmul_plain(x, w).float(),
                                       rtol=2e-2, atol=2e-2)
    assert ops.launches()["qmatmul_q5"] == 2 and ops.launches()["qmatmul_q8"] == 1


# S = 577 (ViT-L/14-336), S = 584 with valid_len 577 (its pad-once length),
# d_head 80 at S = 257 (ViT-H/14) and the largest single-image S, 640
_LONG = [(2, 577, 2, 64, None), (1, 584, 2, 64, 577), (2, 257, 2, 80, None),
         (1, 640, 1, 80, None)]


@pytest.mark.parametrize("b,s,nh,dh,vl", _LONG)
def test_attention_heads_long_sequences(card, b, s, nh, dh, vl):
    rng = np.random.default_rng(11)
    qkv = _x(rng, (b * s, 3 * nh * dh), card)
    out = at.attention_heads(qkv, b, s, nh, dh ** -0.5, valid_len=vl)
    torch.cuda.synchronize()
    ref = at.attention_heads_plain(qkv, b, s, nh, dh ** -0.5, valid_len=vl)
    assert _cos(out, ref) > 0.9999
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("b,s,nh,dh,vl,causal", [(3, 13, 4, 64, None, False),
                                                  (3, 13, 4, 64, 9, False),
                                                  (2, 80, 2, 64, None, True),
                                                  *[(*c, False) for c in _LONG]])
def test_mha_qkv_matches_plain(card, b, s, nh, dh, vl, causal):
    rng = np.random.default_rng(12)
    qkv = _x(rng, (b, s, 3 * nh * dh), card)
    kw = dict(n_head=nh, scale=dh ** -0.5, causal=causal, valid_len=vl)
    out = at.mha_qkv(qkv, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, nh * dh)
    torch.testing.assert_close(out, at.mha_qkv_plain(qkv, **kw), rtol=1.6e-2, atol=1e-3)


def test_mha_qkv_raises_past_shared_memory(card):
    """The tiled core's shared memory does not grow with S: S = 700 (past
    the first version's 640) matches the plain version; a d_head that is not
    a multiple of 16 raises before a launch, and so does the f32 form (which
    holds a head's K and V in shared memory) at S = 700."""
    rng = np.random.default_rng(30)
    qkv = _x(rng, (1, 700, 3 * 80), card)
    kw = dict(n_head=1, scale=80 ** -0.5)
    out = at.mha_qkv(qkv, **kw)
    want = at.mha_qkv_plain(qkv, **kw)
    assert _cos(out, want) > 0.9999
    torch.testing.assert_close(out, want, rtol=1.6e-2, atol=1e-3)
    with pytest.raises(ValueError, match="multiple of 16"):
        at.mha_qkv(_x(rng, (1, 40, 3 * 72), card), n_head=1, scale=0.1)
    q = _x(rng, (1, 700, 80), card).float()
    with pytest.raises(ValueError, match="shared memory"):
        at.mha(q, q, q, n_head=1, scale=0.1)


# the tiled tensor-core core: ragged query tiles (S = 65, 129), d_head 32 and
# 80, causal across several tiles, valid_len inside the last tile
_TILED = [(2, 65, 2, 64, None, False), (1, 129, 3, 32, None, False),
          (2, 129, 2, 80, None, True), (1, 200, 2, 32, None, True),
          (3, 65, 2, 80, 61, False), (1, 257, 2, 48, 200, True), (2, 50, 2, 128, None, False)]


@pytest.mark.parametrize("out_bf16", [False, True])
@pytest.mark.parametrize("b,s,nh,dh,vl,causal", _TILED)
def test_attention_tiles_match_plain(card, b, s, nh, dh, vl, causal, out_bf16):
    rng = np.random.default_rng(31)
    qkv = _x(rng, (b, s, 3 * nh * dh), card)
    kw = dict(n_head=nh, scale=dh ** -0.5, causal=causal, valid_len=vl)
    if out_bf16:
        out, want = at.mha_qkv(qkv, **kw), at.mha_qkv_plain(qkv, **kw)
        tol = dict(rtol=1.6e-2, atol=1e-3)
    else:
        q2 = qkv.reshape(b * s, -1)
        out = at.attention_heads(q2, b, s, nh, kw["scale"], causal, vl)
        want = at.attention_heads_plain(q2, b, s, nh, kw["scale"], causal, vl)
        tol = dict(rtol=1e-3, atol=1e-3)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _cos(out, want) > 0.9999
    torch.testing.assert_close(out, want, **tol)


def test_attention_is_deterministic(card):
    """The second pass recomputes the first pass's scores bit for bit, and
    two launches give the same bits (rows 8 and 12 rely on it)."""
    rng = np.random.default_rng(32)
    qkv = _x(rng, (2 * 584, 3 * 2 * 64), card)
    a = at.attention_heads(qkv, 2, 584, 2, 0.125, valid_len=577)
    assert torch.equal(a, at.attention_heads(qkv, 2, 584, 2, 0.125, valid_len=577))


def test_mha_raises_on_misaligned_pointers(card):
    """The tensor-core kernels copy 16-byte chunks with cp.async: a view
    whose data starts off a 16-byte boundary raises before a launch."""
    rng = np.random.default_rng(33)
    buf = _x(rng, (3 * 13 * 128 + 1,), card)
    q = buf[1:].reshape(3, 13, 128)
    k = v = _x(rng, (3, 13, 128), card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.mha(q, k, v, n_head=2, scale=0.125)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    rng = np.random.default_rng(7)
    x = torch.zeros(4, 128, device=card)  # float32: the kernels take bf16
    w, b = _vec(rng, 128, card), _vec(rng, 128, card)
    with pytest.raises(TypeError):
        aq.lnq(x, w, b, 1e-5)
    with pytest.raises(ValueError):
        aq.lnq(torch.zeros(4, 256, device=card).bfloat16()[:, :128], w, b, 1e-5)  # strided


def test_engine_kernels_match_plain(card, tmp_path, monkeypatch):
    from clip_tpu_torch import ops, synth
    from clip_tpu_torch.engine import ClipEngine

    monkeypatch.setitem(synth.VARIANTS, "test-128",
                        synth.Variant(128, 4, 2, 256, 128, 4, 2, 256, 64, 32, 64))
    path = synth.make_synthetic_gguf(str(tmp_path / "t128.gguf"), "test-128", ftype="q4_0")
    eng = ClipEngine(path, verbosity=0)
    ref = ClipEngine(path, compute_dtype="float32", kernels=False, verbosity=0)
    rng = np.random.default_rng(8)
    imgs = [(rng.random((70, 90, 3)) * 255).astype(np.uint8) for _ in range(3)]
    ops.reset_launches()
    a_img, a_txt = eng.encode_image(imgs), eng.encode_text(["a photo of a cat", "dog"])
    assert ops.launches()["attn_block"] == 4 and ops.launches()["qmatmul_q4"] == 2
    b_img, b_txt = ref.encode_image(imgs), ref.encode_text(["a photo of a cat", "dog"])
    assert (a_img * b_img).sum(1).min() > 0.999
    assert (a_txt * b_txt).sum(1).min() > 0.999


def test_engine_dense_kernels_match_plain(card, tmp_path, monkeypatch):
    """An f16 checkpoint takes the dense route: ``mha_qkv`` once per layer,
    no block chain; agreement with the plain route in f32."""
    from clip_tpu_torch import ops, synth
    from clip_tpu_torch.engine import ClipEngine

    monkeypatch.setitem(synth.VARIANTS, "test-128",
                        synth.Variant(128, 4, 2, 256, 128, 4, 2, 256, 64, 32, 64))
    path = synth.make_synthetic_gguf(str(tmp_path / "t128.gguf"), "test-128", ftype="f16")
    eng = ClipEngine(path, verbosity=0)
    ref = ClipEngine(path, compute_dtype="float32", kernels=False, verbosity=0)
    assert eng.route == "dense"
    rng = np.random.default_rng(13)
    imgs = [(rng.random((70, 90, 3)) * 255).astype(np.uint8) for _ in range(3)]
    ops.reset_launches()
    a_img, a_txt = eng.encode_image(imgs), eng.encode_text(["a photo of a cat", "dog"])
    n = ops.launches()
    assert n["mha_qkv"] == 4 and n["attn_block"] == 0 and n["mlp_lnq"] == 0
    b_img, b_txt = ref.encode_image(imgs), ref.encode_text(["a photo of a cat", "dog"])
    assert (a_img * b_img).sum(1).min() > 0.999
    assert (a_txt * b_txt).sum(1).min() > 0.999


def _codes(rng, m, k, dev):
    codes = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(dev)
    return codes, _vec(rng, m, dev, 0.02, 0.005).abs()


def _close_codes(codes, sx, pc, psx, rtol):
    """Row-quant outputs against the plain version's: scales within
    ``rtol``, codes within 1, and almost all equal."""
    torch.testing.assert_close(sx, psx, rtol=rtol, atol=0)
    diff = (codes.int() - pc.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("act", ["gelu_quick", "gelu_tanh", "none"])
def test_gemm_gq_matches_plain(card, act):
    rng = np.random.default_rng(14)
    codes, sx = _codes(rng, 133, 128, card)
    w8, ws = _w8(rng, 264, 128, card)
    bias = _vec(rng, 264, card)
    oc, osx = aq.gemm_gq(codes, sx, w8, ws, bias, act)
    pc, psx = aq.gemm_gq_plain(codes, sx, w8, ws, bias, act)
    _close_codes(oc, osx, pc, psx, 1e-5)


def test_w8a8_pre_matches_plain(card):
    rng = np.random.default_rng(15)
    codes, sx = _codes(rng, 70, 192, card)
    w8, ws = _w8(rng, 136, 192, card)
    out = aq.w8a8_pre(codes, sx, w8, ws)
    assert out.dtype == torch.bfloat16 and out.shape == (70, 136)
    assert torch.equal(out, aq.w8a8_pre_plain(codes, sx, w8, ws))


def test_mlp_gq_matches_plain(card):
    rng = np.random.default_rng(16)
    codes, sx = _codes(rng, 77, 128, card)
    up8, upws = _w8(rng, 512, 128, card)
    dn8, dnws = _w8(rng, 128, 512, card)
    args = (codes, sx, up8, upws, _vec(rng, 512, card), dn8, dnws)
    out = aq.mlp_gq(*args)
    assert out.dtype == torch.bfloat16 and out.shape == (77, 128)
    assert _cos(out, aq.mlp_gq_plain(*args, out_dtype=torch.float32)) > 0.999


@pytest.mark.parametrize("quant_out", [False, True])
@pytest.mark.parametrize("b,s,nh,dh,vl,causal", [(3, 13, 4, 64, None, False),
                                                  (3, 13, 4, 64, 9, False),
                                                  (2, 80, 2, 64, None, True),
                                                  (2, 50, 2, 80, None, False),
                                                  (1, 584, 2, 64, 577, False),
                                                  (1, 640, 1, 80, None, False),
                                                  (2, 65, 2, 80, None, False),
                                                  (1, 129, 2, 80, None, True),
                                                  (2, 129, 2, 80, 100, False),
                                                  (1, 200, 3, 32, None, True)])
def test_mha_qkv_i8_matches_plain(card, b, s, nh, dh, vl, causal, quant_out):
    rng = np.random.default_rng(17)
    codes = torch.from_numpy(rng.integers(-127, 128, (b, s, 3 * nh * dh), dtype=np.int8))
    codes = codes.to(card)
    scales = _vec(rng, b * s, card, 0.02, 0.005).abs().reshape(b, s)
    kw = dict(n_head=nh, scale=dh ** -0.5, causal=causal, valid_len=vl, quant_out=quant_out)
    out = at.mha_qkv_i8(codes, scales, **kw)
    torch.cuda.synchronize()
    ref = at.mha_qkv_i8_plain(codes, scales, **kw)
    if quant_out:
        _close_codes(out[0], out[1], ref[0], ref[1], 1e-4)
    else:
        assert out.dtype == torch.bfloat16 and out.shape == (b, s, nh * dh)
        torch.testing.assert_close(out, ref, rtol=1.6e-2, atol=1e-3)


def test_w8_projection_routes_by_rows(card):
    """A W8Tensor that keeps its q4_0 source takes ``qmatmul_q4`` on the
    source at 2048 rows or fewer and the int8 GEMM (``w8a8_pre``) above."""
    from clip_tpu_torch import ops
    from clip_tpu_torch.ops.linear import qmatmul, w8a8_matmul

    rng = np.random.default_rng(18)
    src = from_ggml_blocks(quantize(rng.normal(0, 0.05, (64, 128)).astype(np.float32),
                                    GGMLType.Q4_0), (64, 128), GGMLType.Q4_0)
    w = to_w8tensor(src, keep_source=True).to(card)
    ops.reset_launches()
    for rows in (2048, 2049):
        x = _x(rng, (rows, 128), card)
        y = qmatmul(x, w)
        want = qmatmul_plain(x, w.qt) if rows <= 2048 else w8a8_matmul(x, w, kernels=False)
        torch.testing.assert_close(y.float(), want.float(), rtol=2e-2, atol=2e-2)
    n = ops.launches()
    assert n["qmatmul_q4"] == 1 and n["w8a8_pre"] == 1


def _w8_layer(rng, h, f, dev):
    def w(n, k):
        src = from_ggml_blocks(quantize(rng.normal(0, 0.05, (n, k)).astype(np.float32),
                                        GGMLType.Q4_0), (n, k), GGMLType.Q4_0)
        return to_w8tensor(src, keep_source=True).to(dev)

    return {"ln1_w": _vec(rng, h, dev, 1.0, 0.1), "ln1_b": _vec(rng, h, dev),
            "qkv_w": w(3 * h, h), "qkv_b": _vec(rng, 3 * h, dev), "o_w": w(h, h),
            "o_b": _vec(rng, h, dev), "ln2_w": _vec(rng, h, dev, 1.0, 0.1),
            "ln2_b": _vec(rng, h, dev), "up_w": w(f, h), "up_b": _vec(rng, f, dev),
            "down_w": w(h, f), "down_b": _vec(rng, h, dev)}


# flag set -> (B, S, flags, wrappers that must launch)
_STAGED = {
    "staged_quant_o": (4, 8, dict(attn_block=False), ("lnq", "w8a8_pre", "attention_heads")),
    "staged_bf16": (1, 6, dict(attn_block=False), ("lnq", "w8a8_pre", "mha_qkv", "qmatmul_q4")),
    "mlp_staged": (4, 8, dict(mlp_full=False), ("attn_block", "gemm_gq")),
    "up_gq": (4, 8, dict(lnq_fuse=False, up_gq=True), ("mha_qkv", "mlp_gq", "qmatmul_q4")),
    "up_gq_split": (4, 8, dict(lnq_fuse=False, up_gq=True, mlp_full=False),
                    ("gemm_gq", "w8a8_pre")),
    "attn_i8": (4, 8, dict(attn_block=False, attn_i8=True), ("gemm_gq", "mha_qkv_i8")),
}


@pytest.mark.parametrize("flags", list(_STAGED))
def test_staged_block_matches_plain(card, flags):
    from clip_tpu_torch import ops
    from clip_tpu_torch.models import transformer

    rng = np.random.default_rng(19)
    b, s, fl, wrappers = _STAGED[flags]
    lp = _w8_layer(rng, 128, 512, card)
    x = _x(rng, (b, s, 128), card)
    kw = dict(n_head=4, eps=1e-5, use_gelu=False, **fl)
    ops.reset_launches()
    out = transformer.block(x, lp, **kw)
    torch.cuda.synchronize()
    n = ops.launches()
    assert all(n[w] > 0 for w in wrappers), n
    ref = transformer.block(x.float(), lp, kernels=False, **kw)
    assert out.dtype == torch.bfloat16 and _cos(out, ref) > 0.999


def test_device_preprocess_matches_host(card):
    from clip_tpu_torch.ops.device_preprocess import device_preprocess
    from clip_tpu_torch.preprocess import preprocess_batch

    mean = np.array([0.48145466, 0.4578275, 0.40821073])
    std = np.array([0.26862954, 0.26130258, 0.27577711])
    imgs = np.random.default_rng(20).integers(0, 256, (3, 97, 131, 3), dtype=np.uint8)
    out = device_preprocess(imgs, 64, mean, std, device=card)
    assert out.is_cuda and out.dtype == torch.float32
    np.testing.assert_allclose(out.cpu().numpy(), preprocess_batch(list(imgs), 64, mean, std),
                               atol=5e-4)


def test_engine_up_gq_matches_plain(card, tmp_path, monkeypatch):
    """``lnq_fuse=False`` on a card runs the no-lnq attention and the
    ``up_gq`` MLP (``mlp_gq``); agreement with the plain route in f32."""
    from clip_tpu_torch import ops, synth
    from clip_tpu_torch.engine import ClipEngine

    monkeypatch.setitem(synth.VARIANTS, "test-128",
                        synth.Variant(128, 4, 2, 256, 128, 4, 2, 256, 64, 32, 64))
    path = synth.make_synthetic_gguf(str(tmp_path / "t128.gguf"), "test-128", ftype="q4_0")
    eng = ClipEngine(path, lnq_fuse=False, verbosity=0)
    ref = ClipEngine(path, lnq_fuse=False, compute_dtype="float32", kernels=False, verbosity=0)
    assert eng._upgq_active
    rng = np.random.default_rng(21)
    imgs = [(rng.random((70, 90, 3)) * 255).astype(np.uint8) for _ in range(3)]
    ops.reset_launches()
    a_img, a_txt = eng.encode_image(imgs), eng.encode_text(["a photo of a cat", "dog"])
    n = ops.launches()
    assert n["mlp_gq"] == 4 and n["attn_block"] == 0 and n["mlp_lnq"] == 0, n
    b_img, b_txt = ref.encode_image(imgs), ref.encode_text(["a photo of a cat", "dog"])
    assert (a_img * b_img).sum(1).min() > 0.999
    assert (a_txt * b_txt).sum(1).min() > 0.999


# -- the streamed routes' kernels and the last three TPU kernels --------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "gelu_quick", "gelu_tanh"])
def test_actq_matches_plain(card, act, dtype):
    y = torch.from_numpy(np.random.default_rng(22).normal(0, 2, (45, 516)).astype(np.float32))
    y = y.to(card).to(dtype)
    codes, sx = aq.actq(y, act)
    pc, psx = aq.actq_plain(y, act)
    assert sx.shape == (45,)
    torch.testing.assert_close(sx, psx, rtol=1e-6, atol=0)
    assert int((codes.int() - pc.int()).abs().max()) <= 1


@pytest.mark.parametrize("group", [4, 128, 512])
def test_requant_groups_match_plain(card, group):
    y = torch.from_numpy(np.random.default_rng(23).normal(0, 2, (37, 1024)).astype(np.float32))
    codes, sx = aq.requant(y.to(card), group=group)
    pc, psx = aq.requant_plain(y.to(card), group=group)
    assert sx.shape == (37, 1024 // group)
    torch.testing.assert_close(sx, psx, rtol=1e-6, atol=0)
    assert int((codes.int() - pc.int()).abs().max()) <= 1


@pytest.mark.parametrize("group", [64, 128, 256])
@pytest.mark.parametrize("epilogue", ["pre_bias", "bias", "residual"])
def test_gemm_i8_grouped_exact(card, group, epilogue):
    """The grouped epilogue equals its plain version bit for bit, with one
    group the residual epilogue too; M and N fill no tile."""
    rng = np.random.default_rng(24)
    m, k, n = 133, 256, 136
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(card)
    b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(card)
    sx = torch.from_numpy(rng.uniform(0.005, 0.02, (m, k // group)).astype(np.float32)).to(card)
    ws, bias = _vec(rng, n, card, 0.01, 0.001), _vec(rng, n, card)
    bias = None if epilogue == "pre_bias" else bias
    resid = _x(rng, (m, n), card) if epilogue == "residual" else None
    got = aq.gemm_i8(a, b, sx, ws, bias, aq.GROUPED, resid=resid, group=group)
    assert torch.equal(got, aq.gemm_i8_plain(a, b, sx, ws, bias, aq.GROUPED, resid=resid,
                                             group=group))
    if epilogue == "residual":
        one = aq.gemm_i8(a, b, sx[:, :1].contiguous(), ws, bias, aq.GROUPED, resid=resid, group=k)
        assert torch.equal(one, aq.gemm_i8(a, b, sx[:, 0].contiguous(), ws, bias, aq.RESID,
                                           resid=resid))


@pytest.mark.parametrize("mode", ["plain", "causal", "valid_len"])
def test_attn_block_stream_matches_plain(card, mode):
    """Row 8 at h 256, 4 heads in groups of 2, B 3, S 16; with one group it
    is the resident block's chain bit for bit."""
    rng = np.random.default_rng(25)
    b, s, h, nh = 3, 16, 256, 4
    qw8, qws = _w8(rng, 3 * h, h, card)
    ow8, ows = _w8(rng, h, h, card)
    args = (_x(rng, (b, s, h), card), _vec(rng, h, card, 1.0, 0.1), _vec(rng, h, card),
            qw8, qws, _vec(rng, 3 * h, card), ow8, ows, _vec(rng, h, card))
    kw = dict(n_head=nh, scale=1.0 / (h // nh) ** 0.5, eps=1e-5, causal=mode == "causal",
              valid_len=11 if mode == "valid_len" else None)
    out = at.attn_block_stream(*args, residual=True, hg=2, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, h)
    assert _cos(out, at.attn_block_stream_plain(*args, residual=True, hg=2, **kw)) > 0.999
    pre = at.attn_block_stream(*args[:-1], hg=2, **kw)
    assert _cos(pre, at.attn_block_stream_plain(*args[:-1], hg=2, **kw)) > 0.999
    assert torch.equal(at.attn_block_stream(*args, residual=True, hg=nh, **kw),
                       at.attn_block(*args, **kw))


@pytest.mark.parametrize("chunks", [None, 1, 4])
def test_mlp_lnq_stream_matches_plain(card, chunks):
    """Row 9 over 77 rows at h 128, f 512: ``exact=True`` and one chunk are
    the resident block bit for bit; four chunks against the plain version."""
    rng = np.random.default_rng(26)
    h, f = 128, 512
    up8, upws = _w8(rng, f, h, card)
    dn8, dnws = _w8(rng, h, f, card)
    args = (_x(rng, (77, h), card), _vec(rng, h, card, 1.0, 0.1), _vec(rng, h, card),
            up8, upws, _vec(rng, f, card), dn8, dnws, _vec(rng, h, card))
    kw = dict(eps=1e-5, residual=True, exact=chunks is None, n_chunks=chunks)
    out = aq.mlp_lnq_stream(*args, **kw)
    if chunks in (None, 1):
        assert torch.equal(out, aq.mlp_lnq(*args, eps=1e-5))
    assert _cos(out, aq.mlp_lnq_stream_plain(*args, **kw)) > 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_matches_plain(card, dtype, causal):
    rng = np.random.default_rng(27)
    q, k, v = (_x(rng, (3, 13, 128), card).to(dtype) for _ in range(3))
    kw = dict(n_head=2, scale=0.125, causal=causal)
    out = at.mha(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == (3, 13, 128)
    want = at.mha_plain(q, k, v, **kw)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-3)
    torch.testing.assert_close(out.float(), want.float(), **tol)


def test_layer_block_is_the_two_blocks(card):
    rng = np.random.default_rng(28)
    b, s, h, f, nh = 3, 8, 128, 512, 2
    qw8, qws = _w8(rng, 3 * h, h, card)
    ow8, ows = _w8(rng, h, h, card)
    up8, upws = _w8(rng, f, h, card)
    dn8, dnws = _w8(rng, h, f, card)
    x = _x(rng, (b, s, h), card)
    attn = (_vec(rng, h, card, 1.0, 0.1), _vec(rng, h, card), qw8, qws, _vec(rng, 3 * h, card),
            ow8, ows, _vec(rng, h, card))
    mlp = (_vec(rng, h, card, 1.0, 0.1), _vec(rng, h, card), up8, upws, _vec(rng, f, card),
           dn8, dnws, _vec(rng, h, card))
    kw = dict(n_head=nh, scale=0.125, eps=1e-5, causal=True)
    out = at.layer_block(x, *attn, *mlp, **kw)
    xm = at.attn_block(x, *attn, **kw).reshape(b * s, h)
    assert torch.equal(out, aq.mlp_lnq(xm, *mlp, eps=1e-5).reshape(b, s, h))
    assert _cos(out, at.layer_block_plain(x, *attn, *mlp, **kw)) > 0.999


@pytest.mark.parametrize("row", ["attn_block_stream", "mlp_lnq_stream"])
def test_stream_routes_match_plain(card, row):
    """The streamed routes through ``transformer.block``: width 768 at
    S = 584 (valid 577), and width 1280 with ``mlp_stream=True``."""
    from clip_tpu_torch import ops
    from clip_tpu_torch.models import transformer

    rng = np.random.default_rng(29)
    if row == "attn_block_stream":
        h, s, flags, vl = 768, 584, {}, 577
    else:
        h, s, flags, vl = 1280, 24, dict(mlp_stream=True), None
    lp = _w8_layer(rng, h, 4 * h, card)
    x = _x(rng, (1, s, h), card)
    kw = dict(n_head=h // 64, eps=1e-5, use_gelu=False, valid_len=vl, **flags)
    ops.reset_launches()
    out = transformer.block(x, lp, **kw)
    torch.cuda.synchronize()
    assert ops.launches()[row] == 1
    ref = transformer.block(x.float(), lp, kernels=False, **kw)
    assert out.dtype == torch.bfloat16 and _cos(out, ref) > 0.999


# -- the wgmma GEMMs (ctt_gemm_i8 on every tile, ctt_gemm_gq) ---------------------

def _i8(rng, shape, dev):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)


def _gemm_args(rng, m, n, k, mode, dev):
    a, b = _i8(rng, (m, k), dev), _i8(rng, (n, k), dev)
    sx, ws = _vec(rng, m, dev, 0.01, 0.001), _vec(rng, n, dev, 0.001, 1e-4)
    bias = _vec(rng, n, dev)
    resid = _x(rng, (m, n), dev) if mode == aq.RESID else None
    return a, b, sx, ws, bias, resid


def _launch_tile(tile, a, b, sx, ws, bias, mode, resid=None, group=None):
    """``ctt_gemm_i8`` on a given tile of ``GEMM_TILES``, whatever the plan
    would choose."""
    from clip_tpu_torch.ops import _cuda

    m, k = a.shape
    n = b.shape[0]
    out = torch.empty(m, n, dtype=aq._GEMM_OUT[mode], device=a.device)
    _cuda.check(_cuda.lib().ctt_gemm_i8(
        a.data_ptr(), b.data_ptr(), m, n, k, _cuda.ptr(sx), _cuda.ptr(ws),
        _cuda.ptr(bias) if mode not in (aq.ACC, aq.PRE) else None, _cuda.ptr(resid), out.data_ptr(),
        mode, group or k, tile, _cuda.stream(a)), "ctt_gemm_i8")
    return out


_EXACT = [aq.ACC, aq.BIAS, aq.RESID, aq.PRE, aq.BIAS_F32]


@pytest.mark.parametrize("tile", range(len(aq.GEMM_TILES)))
@pytest.mark.parametrize("mode", _EXACT + [aq.GELU_QUICK, aq.GELU_TANH])
def test_every_tile_matches_plain(card, tile, mode):
    """Each tile of ``GEMM_TILES`` on a ragged shape (M, N fill no tile, K
    ends in half a stage): bit-equal where ``test_gemm_i8_exact`` asks it,
    the GELU modes to its tolerance."""
    rng = np.random.default_rng(40 + tile)
    a, b, sx, ws, bias, resid = _gemm_args(rng, 133, 264, 192, mode, card)
    got = _launch_tile(tile, a, b, sx, ws, bias, mode, resid)
    want = aq.gemm_i8_plain(a, b, sx, ws, bias, mode, resid=resid)
    if mode in _EXACT:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [1, 50, 133, 584, 4672])
@pytest.mark.parametrize("n,k", [(136, 128), (264, 192), (776, 768), (2304, 1280), (128, 5120)])
def test_gemm_i8_accumulator_at_plan_boundaries(card, m, n, k):
    """The int32 accumulator, exact, at row counts that take every tile of
    the plan, N not a multiple of any tile's width, K from 128 to 5120."""
    rng = np.random.default_rng(41)
    a, b = _i8(rng, (m, k), card), _i8(rng, (n, k), card)
    assert torch.equal(aq.gemm_i8(a, b, None, None, None, aq.ACC),
                       aq.gemm_i8_plain(a, b, None, None, None, aq.ACC))


@pytest.mark.parametrize("m", [50, 584, 4672])
@pytest.mark.parametrize("mode", _EXACT + [aq.GELU_QUICK, aq.GELU_TANH])
def test_gemm_i8_epilogues_at_path_rows(card, m, mode):
    rng = np.random.default_rng(42)
    a, b, sx, ws, bias, resid = _gemm_args(rng, m, 776, 768, mode, card)
    got = aq.gemm_i8(a, b, sx, ws, bias, mode, resid=resid)
    want = aq.gemm_i8_plain(a, b, sx, ws, bias, mode, resid=resid)
    if mode in _EXACT:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [50, 584, 4672])
@pytest.mark.parametrize("k,group", [(1280, 64), (768, 256), (5120, 640)])
def test_gemm_i8_grouped_at_path_rows(card, m, k, group):
    """The grouped epilogue's flush (mid-stage for groups of 64), bit-equal
    to its plain version on the tiles the plan takes at these rows."""
    rng = np.random.default_rng(43)
    n = 1280
    a, b = _i8(rng, (m, k), card), _i8(rng, (n, k), card)
    sx = torch.from_numpy(rng.uniform(0.005, 0.02, (m, k // group)).astype(np.float32)).to(card)
    ws, bias, x = _vec(rng, n, card, 0.01, 0.001), _vec(rng, n, card), _x(rng, (m, n), card)
    got = aq.gemm_i8(a, b, sx, ws, bias, aq.GROUPED, resid=x, group=group)
    assert torch.equal(got, aq.gemm_i8_plain(a, b, sx, ws, bias, aq.GROUPED, resid=x,
                                             group=group))


def _chain(codes, sx, w8, ws, bias, act, group=None):
    """The two-launch chain ``ctt_gemm_gq`` replaces."""
    return aq.requant(aq.gemm_i8(codes, w8, sx, ws, bias, aq._ACT_MODE[act]), group=group)


@pytest.mark.parametrize("act", ["gelu_quick", "gelu_tanh", "none"])
@pytest.mark.parametrize("n", [2048, 3072, 4096, 5120, 264])
@pytest.mark.parametrize("m", [1, 133])
def test_gemm_gq_equals_the_chain(card, act, n, m):
    """``ctt_gemm_gq`` (one launch, the full-row requant on chip) against
    ``requant(gemm_i8(...))``: codes and scales bit for bit."""
    rng = np.random.default_rng(44)
    codes, sx = _codes(rng, m, 256, card)
    w8, ws = _w8(rng, n, 256, card)
    bias = _vec(rng, n, card)
    aq.gemm_gq.launches = 0
    oc, osx = aq.gemm_gq(codes, sx, w8, ws, bias, act)
    assert aq.gemm_gq.launches == 1
    cc, csx = _chain(codes, sx, w8, ws, bias, act)
    assert torch.equal(osx, csx) and torch.equal(oc, cc)


@pytest.mark.parametrize("n,c", [(5120, 8), (5120, 4), (3072, 4), (2048, 2)])
def test_gemm_gq_chunks_equal_the_chain(card, n, c):
    """The streamed MLP's per-chunk requant (groups of 4H / c) on chip,
    against ``requant(gemm_i8(...), group=4H / c)``."""
    rng = np.random.default_rng(45)
    codes, sx = _codes(rng, 133, 1280, card)
    w8, ws = _w8(rng, n, 1280, card)
    bias = _vec(rng, n, card)
    oc, osx = aq._gemm_gq(codes, sx, w8, ws, bias, "gelu_quick", n // c)
    cc, csx = _chain(codes, sx, w8, ws, bias, "gelu_quick", group=n // c)
    assert osx.shape == (133, c)
    assert torch.equal(osx, csx) and torch.equal(oc, cc)


@pytest.mark.parametrize("route", ["gemm_gq", "mlp_gq", "mlp_lnq", "stream_exact", "stream_chunks"])
def test_mlp_routes_allocate_no_f32_row(card, route):
    """No f32 ``[rows, 4H]`` tensor on the card: the routes' peak allocation
    stays below the f32 intermediate alone, and no ``ctt_requant`` or f32
    GEMM epilogue runs."""
    from clip_tpu_torch import ops

    rng = np.random.default_rng(46)
    rows, h, f = 4096, 128, 1024
    x = _x(rng, (rows, h), card)
    up8, upws = _w8(rng, f, h, card)
    dn8, dnws = _w8(rng, h, f, card)
    lnw, lnb, upb, dnb = (_vec(rng, h, card, 1.0, 0.1), _vec(rng, h, card), _vec(rng, f, card),
                          _vec(rng, h, card))
    codes, sx = aq.lnq(x, lnw, lnb, 1e-5)
    run = {"gemm_gq": lambda: aq.gemm_gq(codes, sx, up8, upws, upb),
           "mlp_gq": lambda: aq.mlp_gq(codes, sx, up8, upws, upb, dn8, dnws),
           "mlp_lnq": lambda: aq.mlp_lnq(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb, eps=1e-5),
           "stream_exact": lambda: aq.mlp_lnq_stream(x, lnw, lnb, up8, upws, upb, dn8, dnws, dnb,
                                                     eps=1e-5, residual=True),
           "stream_chunks": lambda: aq.mlp_lnq_stream(x, lnw, lnb, up8, upws, upb, dn8, dnws,
                                                      dnb, eps=1e-5, residual=True, exact=False,
                                                      n_chunks=4)}[route]
    run()
    torch.cuda.synchronize()
    ops.reset_launches()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < rows * f * 4, (route, peak)
    n = ops.launches()
    assert n["gemm_gq"] == 1 and n["requant"] == 0, n
    del out


@pytest.mark.parametrize("cpb", aq.GQ_COLUMNS)
def test_gemm_gq_every_block_width(card, cpb):
    """``ctt_gemm_gq`` with each block width of ``GQ_COLUMNS``, whatever
    the plan would choose, over a 1280-wide row (clusters of 4 to 16, some
    blocks past the row's end): bit-equal to the two-launch chain."""
    from clip_tpu_torch.ops import _cuda

    rng = np.random.default_rng(47)
    m, k, n = 133, 256, 1280
    codes, sx = _codes(rng, m, k, card)
    w8, ws = _w8(rng, n, k, card)
    bias = _vec(rng, n, card)
    cs = aq._pow2_at_least(-(-n // cpb))
    out = torch.empty(m, n, dtype=torch.int8, device=card)
    scales = torch.empty(m, 1, dtype=torch.float32, device=card)
    _cuda.check(_cuda.lib().ctt_gemm_gq(
        codes.data_ptr(), w8.data_ptr(), m, n, k, sx.data_ptr(), ws.data_ptr(), bias.data_ptr(),
        out.data_ptr(), scales.data_ptr(), aq.GELU_QUICK, n, cs, cpb, _cuda.stream(codes)),
        "ctt_gemm_gq")
    cc, csx = _chain(codes, sx, w8, ws, bias, "gelu_quick")
    assert torch.equal(scales.reshape(-1), csx) and torch.equal(out, cc)


def test_gemm_gq_codes_at_rounding_ties(card):
    """Small integer operands with unit scales and no bias make act(y) = y
    the int32 product itself, so y / scale lands on or next to the .5 ties
    of the round to int8 again and again: ``ctt_gemm_gq``'s quotients (a
    reciprocal a row and two correction steps) must round exactly as the
    chain's ``__fdiv_rn`` does."""
    rng = np.random.default_rng(48)
    m, k, n = 4096, 128, 2048
    codes = torch.from_numpy(rng.integers(-3, 4, (m, k), dtype=np.int8)).to(card)
    w8 = torch.from_numpy(rng.integers(-3, 4, (n, k), dtype=np.int8)).to(card)
    ones_m = torch.ones(m, device=card)
    ones_n, zeros_n = torch.ones(n, device=card), torch.zeros(n, device=card)
    oc, osx = aq.gemm_gq(codes, ones_m, w8, ones_n, zeros_n, "none")
    cc, csx = _chain(codes, ones_m, w8, ones_n, zeros_n, "none")
    assert torch.equal(osx, csx) and torch.equal(oc, cc)
