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
from clip_tpu_torch.ops.qmatmul import qmatmul_q4, qmatmul_q4_plain
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


@pytest.mark.parametrize("mode", [aq.ACC, aq.BIAS, aq.RESID])
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
    torch.testing.assert_close(qmatmul_q4(x, w).float(), qmatmul_q4_plain(x, w).float(),
                               rtol=2e-2, atol=2e-2)


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
