"""The launch plans of the port's int8 GEMMs, on the CPU.

``ctt_gemm_i8`` takes its tile per launch from ``ops.actquant.gemm_plan``,
and ``ctt_gemm_gq`` spans a requant group with a cluster of blocks from
``ops.actquant.gq_plan``.  Both are plain Python, held here against every
GEMM the shipped configurations reach (``synth.VARIANTS`` and ViT-B/16 at
384 px; vision rows at the pad-once S, text rows at S 80; batches 1 to
256; the qkv, o, up and down GEMMs; every full-row requant width and every
chunk of the streamed MLP):

* the grid of ``gemm_plan``'s tile gives each of the 132 SMs a block
  wherever some tile can, and it is the widest tile that does;
* ``gq_plan``'s cluster spans the group with no block left without
  columns (but at 3840, where no power-of-two cluster avoids one), within
  16 blocks and one block's shared memory;
* the tables that the plans index agree with ``csrc/actquant.cu``.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import pytest
import torch

from clip_tpu_torch import synth
from clip_tpu_torch.models.config import VisionConfig
from clip_tpu_torch.models.vision import pad_once
from clip_tpu_torch.ops import actquant as aq
from clip_tpu_torch.ops import attention as at

CSRC = Path(aq.__file__).resolve().parent.parent / "csrc" / "actquant.cu"
SMEM_LIMIT = 232448  # dynamic shared memory one block may have on an H100


def _vision(v: synth.Variant, image_size: int) -> VisionConfig:
    return VisionConfig(image_size=image_size, patch_size=v.patch_size, hidden_size=v.v_hidden,
                        n_intermediate=v.v_ff, projection_dim=v.projection_dim,
                        n_head=v.v_heads, n_layer=v.v_layers, eps=1e-5)


def _configs():
    """(label, vision config or None, width, MLP width, heads, batches) of
    every shipped tower."""
    out = []
    variants = dict(synth.VARIANTS)
    for name, v in variants.items():
        out.append((f"{name} vision", _vision(v, v.image_size), v.v_hidden, v.v_ff, v.v_heads,
                    (1, 8, 64, 256)))
        out.append((f"{name} text", None, v.t_hidden, v.t_ff, v.t_heads, (1, 4, 8, 64)))
    v = variants["ViT-B/16"]
    out.append(("ViT-B/16-384 vision", _vision(v, 384), v.v_hidden, v.v_ff, v.v_heads, (1, 8)))
    return out


def _rows(cfg, b: int) -> int:
    if cfg is None:
        return b * 80
    s = cfg.num_positions
    return b * pad_once(b, s, cfg, True)


CONFIGS = _configs()


def _blocks(m: int, n: int, tile: int) -> int:
    wg, bn = aq.GEMM_TILES[tile]
    return -(-m // (64 * wg)) * -(-n // bn)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("label,cfg,h,f,nh,batches", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_gemm_plan_fills_the_card(label, cfg, h, f, nh, batches, grouped):
    """Every GEMM of every shipped tower; with ``grouped`` (the streamed o
    and down GEMMs) only the one-warpgroup tiles are candidates."""
    tiles = [i for i, (wg, _) in enumerate(aq.GEMM_TILES) if not (grouped and wg == 2)]
    for b in batches:
        m = _rows(cfg, b)
        for gemm, (n, k) in {"qkv": (3 * h, h), "o": (h, h), "up": (f, h),
                             "down": (h, f)}.items():
            assert k % 64 == 0 and n % 8 == 0, (label, gemm)
            tile = aq.gemm_plan(m, n, grouped)
            assert tile in tiles
            can = [i for i in tiles if _blocks(m, n, i) >= aq.N_SMS]
            if can:
                assert tile == can[0], (label, b, gemm, tile, can)
            else:  # no tile fills the card: the one with the most blocks
                assert _blocks(m, n, tile) == max(_blocks(m, n, i) for i in tiles)


@pytest.mark.parametrize("m,n,tile", [(3200, 2304, 0), (16896, 5120, 0), (12800, 768, 0),
                                      (640, 1536, 2), (584, 768, 3), (584, 3072, 1),
                                      (1168, 1024, 1), (56, 2304, 3), (1, 136, 3)])
def test_gemm_plan_at_named_shapes(m, n, tile):
    """ViT-B/32 qkv at B = 64, ViT-H/14 up, ViT-B/32 o at B = 256, the text
    qkv at 8 prompts, ViT-B/16-384 o and ViT-L/14-336 qkv at B = 1, L/14-336
    o at B = 2, the zero-shot single image, one row."""
    assert aq.gemm_plan(m, n) == tile


def _gq_groups():
    """Every requant group ``ctt_gemm_gq`` takes at the shipped widths: the
    full rows of the up GEMMs (4H) and of the attn_i8 route's qkv GEMM (3H),
    and the chunks of the streamed MLP at every batch."""
    groups = set()
    for _, cfg, h, f, nh, batches in CONFIGS:
        groups.update((f, 3 * h))
        if aq.mlp_stream_fusable(h, f):
            for b in batches:
                rows = _rows(cfg, b)
                groups.add(f // aq._stream_chunks(rows, h, f, False, None))
    return sorted(groups)


def _gq_smem(cpb: int) -> int:
    """Shared memory of a ``ctt_gemm_gq`` block with two stages of A (128
    rows) and B (``cpb`` rows) at 128 bytes of K, the row maxima, scales,
    reciprocals, barriers and alignment (``csrc/gemm_gq.cu`` ``Gq``)."""
    return 1024 + 3 * aq.GQ_ROWS * 4 + 2 * 4 * 8 + 2 * (aq.GQ_ROWS + cpb) * 128


@pytest.mark.parametrize("group", _gq_groups())
def test_gq_plan_spans_the_group(group):
    cs, cpb = aq.gq_plan(group)
    assert cs in (1, 2, 4, 8, 16) and cs <= aq.GQ_MAX_CLUSTER and cpb in aq.GQ_COLUMNS
    assert cs * cpb >= group  # spans it
    empty = cs - -(-group // cpb)
    if group != 3840:  # 3840 = 15 x 256: no power-of-two cluster avoids an empty block
        assert empty == 0, (group, cs, cpb)
    assert empty <= 1
    assert _gq_smem(cpb) <= SMEM_LIMIT
    assert (cpb // 2) % 16 == 0  # a warpgroup's wgmma N


def test_gq_plan_covers_the_widths():
    """The groups include every MLP width (full rows of 2048 to 5120: ViT-H/14
    as a cluster of 16 blocks of 320 columns) and ViT-H/14's 8 chunks of
    640."""
    groups = _gq_groups()
    assert {2048, 3072, 4096, 5120, 640} <= set(groups)
    assert aq.gq_plan(5120) == (16, 320)
    assert aq.gq_plan(2048) == (8, 256)
    assert aq.gq_plan(640) == (2, 320)
    assert aq.gq_plan(264) == (1, 320) and aq.gq_plan(128) == (1, 128)


@pytest.mark.parametrize("group", [5248, 8192])
def test_gq_plan_rejects_wider_groups(group):
    with pytest.raises(ValueError, match="wider"):
        aq.gq_plan(group)


def test_tables_match_the_kernels():
    """``GEMM_TILES`` is the order of ``launch_tile``'s cases, and
    ``GQ_COLUMNS`` the block widths ``ctt_gemm_gq`` instantiates."""
    src = CSRC.read_text()
    cases = re.findall(r"case (\d):\s+(?:if constexpr \(!Grouped\)\s+)?"
                       r"return launch_gemm<(\d), (\d+), (?:Grouped|false)>", src)
    assert [(int(w), int(n)) for _, w, n in sorted(cases)] == list(aq.GEMM_TILES)
    gq = (CSRC.parent / "gemm_gq.cu").read_text()
    cols = re.search(r"switch \(cpb\) \{  // ops.actquant.GQ_COLUMNS\n\s+(.*)\n", gq).group(1)
    assert sorted(int(c) for c in re.findall(r"CTT_GQ\((\d+)\)", cols)) == sorted(aq.GQ_COLUMNS)
    assert f"constexpr int kGqRows = {aq.GQ_ROWS};" in gq
    assert "if (cs < 1 || cs > 16)" in gq and aq.GQ_MAX_CLUSTER == 16


@pytest.mark.parametrize("b,s,h,nh", [(1, 584, 768, 12), (8, 584, 768, 12), (2, 408, 1280, 16),
                                     (2, 328, 1280, 16)])
def test_stream_attention_groups_fit_the_grouped_gemm(b, s, h, nh):
    """The streamed attention block's o GEMM takes groups of hg x d_head
    columns of K: a multiple of 64 that divides K, as the grouped epilogue
    of ``ctt_gemm_i8`` needs."""
    g = at.stream_heads(b, s, h, 3 * h, h, nh) * (h // nh)
    assert g % 64 == 0 and h % g == 0


def test_tma_alignment_is_checked():
    """The int8 operands of the wgmma GEMMs go through TMA: a base address
    or row stride off 16 bytes raises."""
    buf = torch.zeros(4 * 64 + 1, dtype=torch.int8)
    aq._require_tma(buf[:256].view(4, 64), "a")
    with pytest.raises(ValueError, match="16-byte"):
        aq._require_tma(buf[1:].view(4, 64), "a")
    with pytest.raises(ValueError, match="16-byte"):
        aq._require_tma(torch.zeros(4, 72, dtype=torch.int8)[:, :64], "a")
