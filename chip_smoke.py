#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``clip_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one flushed line with its wall seconds:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the kernels of ``clip_tpu_torch/csrc``, one ``nvcc`` process per
   source side by side and one link, with the ``-Xptxas -v`` register and
   spill summary, the tensor-core instructions of the two tiled attention
   kernels and the two wgmma GEMMs counted (HMMA, IMMA and IGMMA in
   ``cuobjdump -sass`` of the library, or ``mma.sync`` and
   ``wgmma.mma_async`` in ``nvcc -ptx`` of their sources where the toolkit
   has no ``cuobjdump``; each must be > 0), and the GEMMs' dynamic shared
   memory, ring stages and the clusters ``ctt_gemm_gq`` fits on the card
   at once.  Meanwhile a pool of
   worker processes writes the seeded random checkpoints of the path
   phases into a temporary directory, and the profiler sets up its device
   tracing;
3. kernels: every kernel wrapper of the fused and dense routes against its
   plain PyTorch version on the card, at the main paths' shapes (ViT-B/32:
   vision rows 64 x 50, text rows 8 x 80 causal, projection M = 64 and
   M = 1 with q4_0/q4_1/q5_0/q5_1/q8_0 [512, 768] weights), and
   ``mha_qkv`` / ``attention_heads`` at the long sequences of other catalog
   models (ViT-H/14's d_head 80 at S = 257, ViT-L/14-336's S = 577 and its
   pad-once S = 584);
4. staged_kernels: the staged routes' wrappers against their plain
   versions at the new paths' shapes (``lnq`` at [64 x 264, 1280] and
   [2 x 584, 1024]; ``gemm_gq`` with gelu at ViT-H/14's up GEMM and with no
   activation at ViT-B/32's qkv GEMM, each also bit-equal to the two-launch
   chain ``requant(gemm_i8(...))``; ``w8a8_pre`` at ViT-H/14's down and
   ViT-L/14-336's qkv GEMM; ``mlp_gq`` at ViT-B/32; ``mha_qkv_i8`` at
   64 x 50, 8 x 80 causal and 2 x 584 valid 577, both output forms), and
   device preprocessing against the host path (atol 5e-4 in pixel space);
4b. stream_kernels: the last five kernels against their plain versions:
   ``attn_block_stream`` at ViT-B/16-384 [1, 584, 768] (valid 577, head
   groups of 4) and at ViT-H/14 width [2, 408, 1280] (groups of 8 heads at
   d_head 80), and with one group bit-equal to ``attn_block``;
   ``mlp_lnq_stream`` at ViT-H/14 [64 x 264, 1280] with ``exact=True`` and
   ``exact=False`` (8 chunks), and bit-equal to ``mlp_lnq`` with
   ``exact=True`` or one chunk; the grouped requant and the grouped GEMM
   epilogue alone (the GEMM bit-equal to its plain version), and
   ``ctt_gemm_gq`` over the 8 chunks bit-equal to the grouped requant of
   the f32 up GEMM; ``actq`` for
   each activation at [16896, 5120]; ``mha`` at ViT-B/32 vision [64, 50,
   768] and causal text [8, 77, 512] in bf16 and f32; ``layer_block`` at
   [64, 50, 768] and causal [8, 80, 512], bit-equal to ``attn_block`` then
   ``mlp_lnq``;
5. paths: ``ClipEngine`` on CUDA, uint8 images (so device preprocessing),
   each drive with every launch counter set to 0 just before it and read
   just after: four ViT-B/32 checkpoints (q4_0 and f16 two towers, 64
   images + 8 prompts + one zero-shot labeling; q5_1 and q8_0 vision, 64
   images); the q4_0 checkpoint once more with ``lnq_fuse=False`` (the
   no-lnq attention and the ``up_gq`` MLP); ViT-H/14 cut to 8 layers (64
   images; staged MLP); ViT-L/14-336 cut to 4 layers (1, 2 and 4 images;
   staged attention, its o projection on the q4_0 source at 584 and 1168
   rows, on the int8 GEMM at 2336); a q4_0 ViT-B/16 vision tower at 384 px,
   all 12 layers (1 and 8 images; S 577 padded to 584: every layer's
   attention on the streamed block, ``attn_block_stream``).  Every counter
   must rise by the count the route implies (the q4_0 path's ``gemm_i8``
   count too), the embeddings must be finite and unit-norm and agree
   (per-row cos > 0.999) with the same engine forced onto its plain
   versions in float32.  The f16 path encodes its images once more with
   bf16 reduced-precision reductions off and reports the largest change;
5b. h14_mlp_stream: the cut ViT-H/14 tower through ``encode_image(...,
   mlp_stream=True)`` at B = 64, every MLP on ``mlp_lnq_stream``, launches
   counted, embeddings bit-equal to the default staged route's;
6. long_sequence: two ViT-L/14-336 layers at the unpadded S = 577 through
   ``run_blocks`` (the staged route), kernels against the plain versions;
7. attn_i8_stacks: two layers on the ``attn_i8`` route at ViT-B/32 vision
   (B 64, S 50) and text (B 8, S 80, causal) widths and ViT-L/14-336's
   (B 2, S 584, valid 577), launches counted, per-row cos > 0.999 against
   the plain float32 stack;
8. route_difference: one ViT-L/14-336 layer at B = 1 and 4, the staged
   route with kernels and the fused chain at S = 577 (the route before the
   route gates) against the staged route in plain float32 (reported);
9. timing (reported, not gated): each kernel, its plain version, one
   PyTorch library call where one computes the same function (SDPA on the
   same q, k, v beside ``mha_qkv`` at every shape of phase 3; on the
   dequantized q, k, v beside ``mha_qkv_i8``: the nearest call, not the
   same function), with the bounds of the attention shapes, the attention
   core alone (``attention_heads``, f32 out) at ViT-B/16-384 [1 and 8,
   584 valid 577, 12 x 64] against SDPA (its cos against the plain version
   > 0.9999 is checked), the q4_0 and f16 ViT-B/32 vision towers at B = 256, the
   ViT-H/14 cut tower at B = 64 and the ViT-L/14-336 cut tower at B = 1 and
   4, each whole and per layer; then (stream_timing) the last five kernels
   and their plain versions at the shapes checked, SDPA on the same q, k, v
   beside ``mha``, the ViT-B/16-384 tower at B = 1 and 8, whole and per
   layer, with its profile at B = 8, and the ViT-H/14 tower with and
   without ``mlp_stream``;
10. gemm_yardsticks: ``gemm_i8`` with the int32 epilogue beside one
   ``torch._int_mm`` call (equal outputs checked) and the bound, at the
   paths' GEMM shapes (ViT-B/32 at B = 256 and its text tower, ViT-H/14's
   up and down, ViT-L/14-336 and ViT-B/16-384 at B = 1), and the grouped
   epilogue at ViT-B/16-384's streamed o GEMM at B = 8.

``python3 chip_smoke.py --gemm-yardsticks`` runs phase 10 alone against the
package beside the script (how a parent's GEMM is timed in the same call:
a copy of this script beside the parent's package).  ``python3
chip_smoke.py --gemm-gq-phases`` builds ``gemm_gq.cu`` with its phase
timestamps and prints where a ``ctt_gemm_gq`` block's time goes at
ViT-H/14's and ViT-B/32's up GEMMs.

It then prints the ``kernels`` JSON line, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises and the script exits nonzero.  It exits nonzero, with no result,
where no CUDA device is present or the package is missing.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12     # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12    # dense bf16 tensor-core peak
T_START = time.perf_counter()


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_line(name: str, t0: float, **info) -> None:
    say(f"[phase] {name} {time.perf_counter() - t0:.2f}s "
        + json.dumps(info, sort_keys=True, default=str))


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cos(a, b) -> float:
    a = a.double().flatten()
    b = b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls,
    between two CUDA events (weights stay in L2 between calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of ``fn`` in ms: ``fn`` is captured once in a CUDA graph
    and the graph replayed ``iters`` times in ``reps`` stretches, each
    between two CUDA events, so the Python and launch overhead of the
    wrappers is left out; the median of the stretches' means, so one slow
    stretch of the card does not set it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    n = max(1, iters // reps)
    means = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / n)
    return statistics.median(means)


def profile_kernels(fn) -> dict:
    """Device time by kernel name over one call of ``fn``
    (``torch.profiler``), and the device's idle share of that call's wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else "not measured",
            "device_ms_by_kernel": top}


# kernel families that must run on the tensor cores: (source, instructions);
# IGMMA is wgmma over int8
TC_KERNELS = {"attention_tc_kernel": ("attention.cu", ("HMMA",)),
              "attention_i8_tc_kernel": ("attention.cu", ("IMMA", "HMMA")),
              "gemm_i8_wgmma_kernel": ("actquant.cu", ("IGMMA",)),
              "gemm_gq_kernel": ("actquant.cu", ("IGMMA",))}
PTX_OPS = {"HMMA": "mma.sync.aligned.m16n8k16", "IMMA": "mma.sync.aligned.m16n8k32",
           "IGMMA": "wgmma.mma_async"}


def tensor_core_counts() -> dict:
    """Tensor-core instructions in the tiled attention kernels and the wgmma
    GEMMs: HMMA, IMMA and IGMMA in ``cuobjdump -sass`` of the built library
    where the toolkit has ``cuobjdump``, else ``mma.sync`` (bf16 and s8
    forms) and ``wgmma.mma_async`` in the PTX of their sources from ``nvcc
    -ptx``.  Raises unless every family has each instruction it needs
    (> 0)."""
    import shutil

    from clip_tpu_torch.ops import _cuda

    nvcc = _cuda._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump")
    counts = {k: {"functions": 0, **dict.fromkeys(PTX_OPS, 0)} for k in TC_KERNELS}
    if cuobjdump:
        source = "cuobjdump -sass"
        text = subprocess.run([cuobjdump, "-sass", str(_cuda.BUILD_DIR / _cuda.LIB_NAME)],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        blocks = text.split("Function : ")[1:]
        ops = {op: op for op in PTX_OPS}
    else:
        source = "nvcc -ptx"
        blocks = []
        with tempfile.TemporaryDirectory() as tmp:
            for src in sorted({src for src, _ in TC_KERNELS.values()}):
                ptx = os.path.join(tmp, src + ".ptx")
                subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=compute_90a",
                                "-std=c++17", "-O3", "-ptx", "-o", ptx,
                                str(_cuda.SRC_DIR / src)],
                               capture_output=True, text=True, timeout=300, check=True)
                with open(ptx) as f:
                    blocks += f.read().split(".entry ")[1:]
        ops = PTX_OPS
    for block in blocks:
        name = block.split(None, 1)[0]
        for fam in TC_KERNELS:
            if fam in name:
                counts[fam]["functions"] += 1
                for op, needle in ops.items():
                    counts[fam][op] += block.count(needle)
    for fam, (_, need) in TC_KERNELS.items():
        c = counts[fam]
        if not c["functions"] or any(c[op] <= 0 for op in need):
            raise AssertionError(f"{fam}: no tensor-core instructions ({source}): {c}")
    return {"read": source, **counts}


def gemm_launch_info() -> dict:
    """Dynamic shared memory of each ``ctt_gemm_i8`` tile, and of
    ``ctt_gemm_gq`` at the cluster plan of each shipped requant width, with
    its ring stages and the clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes

    from clip_tpu_torch.ops import _cuda
    from clip_tpu_torch.ops import actquant as aq

    lib = _cuda.lib()
    out = {"gemm_i8_smem": {f"{64 * wg}x{bn}": lib.ctt_gemm_i8_smem(tile)
                            for tile, (wg, bn) in enumerate(aq.GEMM_TILES)},
           "gemm_gq": {}}
    info = (ctypes.c_int * 3)()
    for g in (2048, 3072, 4096, 5120, 640, 1536, 2304):
        cs, cpb = aq.gq_plan(g)
        _cuda.check(lib.ctt_gemm_gq_info(cs, cpb, info), "ctt_gemm_gq_info")
        out["gemm_gq"][g] = dict(cluster=cs, columns=cpb, smem=info[0], stages=info[1],
                                 max_active_clusters=info[2])
    return out


# the int8 GEMM alone (kAcc) at the paths' shapes: name -> (rows, N, K)
GEMM_SHAPES = {
    "b32_b256_qkv": (12800, 2304, 768), "b32_b256_o": (12800, 768, 768),
    "b32_b256_up": (12800, 3072, 768), "b32_b256_down": (12800, 768, 3072),
    "b32_text_qkv": (640, 1536, 512), "b32_text_o": (640, 512, 512),
    "b32_text_up": (640, 2048, 512), "b32_text_down": (640, 512, 2048),
    "h14_up": (16896, 5120, 1280), "h14_down": (16896, 1280, 5120),
    "l14_336_b1_qkv": (584, 3072, 1024), "l14_336_b1_o": (584, 1024, 1024),
    "l14_336_b1_up": (584, 4096, 1024), "l14_336_b1_down": (584, 1024, 4096),
    "b16_384_b1_qkv": (584, 2304, 768), "b16_384_b1_o": (584, 768, 768),
    "b16_384_b1_up": (584, 3072, 768), "b16_384_b1_down": (584, 768, 3072),
}


def gemm_yardsticks() -> dict:
    """Device time of ``gemm_i8`` with the int32 epilogue (ACC) beside one
    ``torch._int_mm`` call on the same operands (the library column; the
    port never calls it) and the bound (the int8 products at the int8 peak,
    or the bytes: A and B read once, C written once), at ``GEMM_SHAPES``;
    and the grouped epilogue at ViT-B/16-384's streamed o GEMM at B = 8
    (4672 rows, K 768 in groups of 256).  Runs against whichever
    ``clip_tpu_torch`` is first on ``sys.path``."""
    import torch

    from clip_tpu_torch.ops import actquant as aq

    rng = np.random.default_rng(11)
    res: dict = {}
    for name, (m, n, k) in GEMM_SHAPES.items():
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
        b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).cuda()
        got = aq.gemm_i8(a, b, None, None, None, aq.ACC)
        lib = torch._int_mm(a, b.t())
        if not torch.equal(got, lib):
            raise AssertionError(f"gemm_i8 {name}: int32 accumulator differs from torch._int_mm")
        ms = graph_ms(lambda: aq.gemm_i8(a, b, None, None, None, aq.ACC))
        lib_ms = graph_ms(lambda: torch._int_mm(a, b.t()))
        ms_bound, by = bound(m * k + n * k + 4 * m * n, int8_ops=2 * m * n * k)
        res[name] = dict(shape=(m, n, k), ms=ms, int_mm_ms=lib_ms, bound_ms=ms_bound,
                         bound_by=by, peak_share=ms_bound / ms)
    # every tile of GEMM_TILES at six shapes, whatever the plan would take
    from clip_tpu_torch.ops import _cuda

    for name in ("h14_up", "h14_down", "b32_b256_qkv", "b32_b256_o", "b32_text_qkv",
                 "l14_336_b1_o") if hasattr(aq, "GEMM_TILES") else ():
        m, n, k = GEMM_SHAPES[name]
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
        b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).cuda()
        out = torch.empty(m, n, dtype=torch.int32, device="cuda")

        def forced(tile, a=a, b=b, out=out, m=m, n=n, k=k):
            _cuda.check(_cuda.lib().ctt_gemm_i8(a.data_ptr(), b.data_ptr(), m, n, k, None, None,
                                                None, None, out.data_ptr(), aq.ACC, k, tile,
                                                _cuda.stream(a)), "ctt_gemm_i8")

        res[name]["tiles_ms"] = {f"{64 * wg}x{bn}": graph_ms(lambda t=t: forced(t))
                                 for t, (wg, bn) in enumerate(aq.GEMM_TILES)}
        res[name]["plan_tile"] = aq.gemm_plan(m, n)
    m, n, k, g = 8 * 584, 768, 768, 256
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
    b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).cuda()
    sx = torch.from_numpy(rng.uniform(0.005, 0.02, (m, k // g)).astype(np.float32)).cuda()
    ws = torch.from_numpy(rng.uniform(0.005, 0.02, n).astype(np.float32)).cuda()
    x = torch.randn(m, n, device="cuda").bfloat16()
    ms_bound, by = bound(m * k + n * k + 4 * m * (k // g) + 4 * n + 2 * m * n * 2,
                         int8_ops=2 * m * n * k)
    res["b16_384_b8_o_grouped"] = dict(
        shape=(m, n, k), group=g, bound_ms=ms_bound, bound_by=by,
        ms=graph_ms(lambda: aq.gemm_i8(a, b, sx, ws, None, aq.GROUPED, resid=x, group=g)),
        int_mm_ms=graph_ms(lambda: torch._int_mm(a, b.t())))
    return res


def bound(nbytes: float, int8_ops: float = 0.0, bf16_flops: float = 0.0) -> tuple[float, str]:
    """Least time in ms for the card: the larger of the compulsory bytes over
    the memory rate and the operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + bf16_flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def attention_bound(b: int, s: int, hl: int, valid_len: "int | None", in_bytes: float,
                    out_bytes: float) -> tuple[float, str]:
    """Bound of one attention core call over ``[b, s, 3 hl]``: q, k, v read
    once (``in_bytes`` an element), the output written once, and q.k and p.v
    over the keys this run needs (``valid_len`` of them) at the bf16 peak."""
    vl = s if valid_len is None else valid_len
    return bound(b * s * 3 * hl * in_bytes + b * s * hl * out_bytes,
                 bf16_flops=4 * b * s * vl * hl)


def sdpa_ms(q, k, v, causal: bool, scale: float, valid_len: "int | None"):
    """One ``scaled_dot_product_attention`` call on the same q, k, v views
    with the same mask (the library column; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    s = q.shape[-2]
    mask = None
    if valid_len is not None:  # keys >= valid_len masked in every row
        mask = (torch.arange(s, device=q.device) < valid_len).expand(1, 1, s, s)
    try:
        return graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal, scale=scale))
    except RuntimeError as e:
        return f"not measured: {str(e).splitlines()[0]}"


def w8(rng, n: int, k: int, device):
    """Random [n, k] weight re-quantized to per-channel int8 as the loader does."""
    from clip_tpu_torch.ops.qtensor import to_w8tensor

    w = to_w8tensor(rng.normal(0, 0.02, (n, k)).astype(np.float32)).to(device)
    return w.c8, w.ws


def vec(rng, n: int, device, mean: float = 0.0, std: float = 0.02):
    import torch

    return torch.from_numpy(rng.normal(mean, std, n).astype(np.float32)).to(device)


def block_weights(rng, h: int, f: int, device) -> dict:
    qw8, qws = w8(rng, 3 * h, h, device)
    ow8, ows = w8(rng, h, h, device)
    up8, upws = w8(rng, f, h, device)
    dn8, dnws = w8(rng, h, f, device)
    return dict(lnw=vec(rng, h, device, 1.0, 0.1), lnb=vec(rng, h, device, 0.0, 0.1),
                qw8=qw8, qws=qws, qb=vec(rng, 3 * h, device), ow8=ow8, ows=ows,
                ob=vec(rng, h, device), up8=up8, upws=upws, upb=vec(rng, f, device),
                dn8=dn8, dnws=dnws, dnb=vec(rng, h, device))


def check_kernels(device) -> dict:
    """Phase 3: every wrapper against its plain version, at the main paths'
    shapes.  Returns the inputs and errors that the timing phase uses."""
    import torch

    from clip_tpu_torch.gguf.constants import GGMLType
    from clip_tpu_torch.ops import actquant as aq
    from clip_tpu_torch.ops import attention as at
    from clip_tpu_torch.ops.nn import layernorm_f32
    from clip_tpu_torch.ops.qmatmul import qmatmul_plain, qmatmul_q4, qmatmul_q5, qmatmul_q8
    from clip_tpu_torch.ops.qtensor import from_ggml_blocks
    from clip_tpu_torch.quant import quantize

    rng = np.random.default_rng(0)
    out: dict = {}
    fails: list[str] = []

    def expect(ok: bool, msg: str) -> None:
        if not ok:
            fails.append(msg)

    def same_codes(name, codes, sx, pc, psx, y) -> int:
        """Row-quant outputs against the plain version's: scales to f32
        rounding, codes equal except by 1 at rounding ties of the plain
        values.  Returns the number of codes that differ."""
        expect(bool(torch.allclose(sx, psx, rtol=1e-6, atol=0)), f"{name}: scales differ")
        diff = (codes.int() - pc.int()).abs()
        expect(int(diff.max()) <= 1, f"{name}: code diff {int(diff.max())}")
        n = int((diff > 0).sum())
        if n:
            v = y.float() / psx[:, None]
            tie = float((v - v.floor() - 0.5).abs()[diff > 0].max())
            expect(tie < 1e-3, f"{name}: {n} codes differ away from a tie ({tie})")
        return n

    shapes = {"vision": (64, 50, 768, 12, 3072, False), "text": (8, 80, 512, 8, 2048, True)}
    for tower, (b, s, h, nh, f, causal) in shapes.items():
        wt = block_weights(rng, h, f, device)
        x = torch.from_numpy(rng.normal(0, 1, (b, s, h)).astype(np.float32)).to(device)
        x = x.to(torch.bfloat16)
        x2 = x.reshape(b * s, h)
        scale = 1.0 / (h // nh) ** 0.5

        codes, sx = aq.lnq(x2, wt["lnw"], wt["lnb"], 1e-5)
        pc, psx = aq.lnq_plain(x2, wt["lnw"], wt["lnb"], 1e-5)
        n_lnq = same_codes(f"lnq {tower}", codes, sx, pc, psx,
                           layernorm_f32(x2, wt["lnw"], wt["lnb"], 1e-5))

        # int8 GEMM: the int32 accumulator and the non-transcendental
        # epilogues equal the plain version exactly
        for mode, w8, ws, bias in ((aq.ACC, "qw8", "qws", "qb"), (aq.BIAS, "qw8", "qws", "qb"),
                                   (aq.RESID, "ow8", "ows", "ob")):
            resid = x2 if mode == aq.RESID else None
            got = aq.gemm_i8(codes, wt[w8], sx, wt[ws], wt[bias], mode, resid=resid)
            want = aq.gemm_i8_plain(codes, wt[w8], sx, wt[ws], wt[bias], mode, resid=resid)
            expect(torch.equal(got, want), f"gemm_i8 mode {mode} {tower}: max diff "
                   f"{float((got.double() - want.double()).abs().max())}")
        up = aq.gemm_i8(codes, wt["up8"], sx, wt["upws"], wt["upb"], aq.GELU_QUICK)
        up_p = aq.gemm_i8_plain(codes, wt["up8"], sx, wt["upws"], wt["upb"], aq.GELU_QUICK)
        expect(bool(torch.allclose(up, up_p, rtol=1e-5, atol=1e-6)),
               f"gemm_i8 gelu {tower}: max diff {float((up - up_p).abs().max())}")
        rc, rs = aq.requant(up_p)
        prc, prs = aq.requant_plain(up_p)
        n_rq = same_codes(f"requant {tower}", rc, rs, prc, prs, up_p)

        qkv = aq.gemm_i8(codes, wt["qw8"], sx, wt["qws"], wt["qb"], aq.BIAS)
        att = at.attention_heads(qkv, b, s, nh, scale, causal)
        att_p = at.attention_heads_plain(qkv, b, s, nh, scale, causal)
        att_cos = cos(att, att_p)
        expect(att_cos > 0.9999, f"attention {tower}: cos {att_cos}")

        # whole blocks in bf16: cos > 0.999 (the JAX package's TPU bound)
        ab_args = (x, wt["lnw"], wt["lnb"], wt["qw8"], wt["qws"], wt["qb"], wt["ow8"],
                   wt["ows"], wt["ob"])
        ab_kw = dict(n_head=nh, scale=scale, eps=1e-5, causal=causal)
        ab = at.attn_block(*ab_args, **ab_kw)
        ab_p = at.attn_block_plain(*ab_args, **ab_kw)
        c_ab = cos(ab, ab_p)
        expect(c_ab > 0.999 and bool(torch.isfinite(ab).all()), f"attn_block {tower}: cos {c_ab}")
        mlp_args = (x2, wt["lnw"], wt["lnb"], wt["up8"], wt["upws"], wt["upb"], wt["dn8"],
                    wt["dnws"], wt["dnb"])
        ml = aq.mlp_lnq(*mlp_args, eps=1e-5)
        ml_p = aq.mlp_lnq_plain(*mlp_args, eps=1e-5)
        c_ml = cos(ml, ml_p)
        expect(c_ml > 0.999 and bool(torch.isfinite(ml).all()), f"mlp_lnq {tower}: cos {c_ml}")
        out[tower] = dict(
            shape=(b, s, h, nh, f), causal=causal, ab_args=ab_args, ab_kw=ab_kw,
            mlp_args=mlp_args, lnq_mismatch=n_lnq, requant_mismatch=n_rq,
            attention_cos=att_cos, attn_block_cos=c_ab, mlp_lnq_cos=c_ml,
            attn_block_err=float((ab.float() - ab_p.float()).abs().max()),
            mlp_lnq_err=float((ml.float() - ml_p.float()).abs().max()))

    # attention with the bf16 output (mha_qkv, the dense route) at the two
    # towers' shapes, ViT-H/14's d_head 80 and ViT-L/14-336's long
    # sequences; attention_heads (f32 out) at S = 577 too
    mha_shapes = {"vision": (64, 50, 12, 64, False, None), "text": (8, 80, 8, 64, True, None),
                  "h14": (4, 257, 16, 80, False, None), "l14_336": (4, 577, 16, 64, False, None),
                  "l14_336_pad": (4, 584, 16, 64, False, 577)}
    out["mha_args"] = {}
    for name, (b, s, nh, dh, causal, vl) in mha_shapes.items():
        qkv = torch.from_numpy(rng.normal(0, 1, (b, s, 3 * nh * dh)).astype(np.float32))
        qkv = qkv.to(device).to(torch.bfloat16)
        kw = dict(n_head=nh, scale=dh ** -0.5, causal=causal, valid_len=vl)
        got, want = at.mha_qkv(qkv, **kw).float(), at.mha_qkv_plain(qkv, **kw).float()
        err = float((got - want).abs().max())
        c = cos(got, want)
        expect(c > 0.9999 and bool(torch.allclose(got, want, rtol=1.6e-2, atol=1e-3)),
               f"mha_qkv {name}: cos {c}, max err {err}")
        out[f"mha_qkv_{name}_err"] = err
        out["mha_args"][name] = (qkv, kw)
    qkv, kw = out["mha_args"]["l14_336"]
    b, s, _ = qkv.shape
    q2 = qkv.reshape(b * s, -1)
    got = at.attention_heads(q2, b, s, kw["n_head"], kw["scale"])
    want = at.attention_heads_plain(q2, b, s, kw["n_head"], kw["scale"])
    c = cos(got, want)
    expect(c > 0.9999, f"attention_heads l14_336: cos {c}")
    out["attention_heads_l14_336_err"] = float((got - want).abs().max())

    # dequant-GEMMs at the projection's shape (M = 64) and at M = 1, every
    # block format
    xq = torch.from_numpy(rng.normal(0, 1, (64, 768)).astype(np.float32)).to(device)
    xq = xq.to(torch.bfloat16)
    out["qmatmul_args"] = {}
    for qtype, fn in ((GGMLType.Q4_1, qmatmul_q4), (GGMLType.Q4_0, qmatmul_q4),
                      (GGMLType.Q5_0, qmatmul_q5), (GGMLType.Q5_1, qmatmul_q5),
                      (GGMLType.Q8_0, qmatmul_q8)):
        wq = from_ggml_blocks(quantize(rng.normal(0, 0.02, (512, 768)).astype(np.float32), qtype),
                              (512, 768), qtype).to(device)
        for m in (64, 1):
            y, y_p = fn(xq[:m], wq).float(), qmatmul_plain(xq[:m], wq).float()
            err = float((y - y_p).abs().max())
            expect(bool(torch.allclose(y, y_p, rtol=2e-2, atol=2e-2)),
                   f"qmatmul {qtype.name} M={m}: {err}")
            out[f"qmatmul_{qtype.name.lower()}_m{m}_err"] = err
        out["qmatmul_args"][qtype.name.lower()] = (xq, wq)
    if fails:
        raise AssertionError("kernel checks failed:\n  " + "\n  ".join(fails))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out


# path name -> (GGUF ftype, towers): seeded random ViT-B/32 checkpoints
PATHS = {"q4_0": ("q4_0", "both"), "f16": ("f16", "both"), "q5_1": ("q5_1", "vision"),
         "q8_0": ("q8_0", "vision")}
# checkpoint name -> (catalog variant, vision layers kept, image size): q4_0
# vision towers at full width, their depth cut (H/14, L/14-336) or their
# image size changed (ViT-B/16 at 384 px, as timm's
# vit_base_patch16_clip_384 towers), registered as variants in the worker
# that writes them
CUT_PATHS = {"h14": ("ViT-H/14", 8, 224), "l14_336": ("ViT-L/14-336", 4, 336),
             "b16_384": ("ViT-B/16", 12, 384)}
# wrappers whose launches each path run reads
PATH_WRAPPERS = ("attn_block", "mlp_lnq", "mha_qkv", "qmatmul_q4", "qmatmul_q5", "qmatmul_q8",
                 "lnq", "gemm_gq", "mlp_gq", "mha_qkv_i8", "w8a8_pre", "attn_block_stream",
                 "mlp_lnq_stream", "actq", "layer_block", "mha")


def write_cut(path: str, variant: str, v_layers: int, image_size: int) -> str:
    """Write a q4_0 vision checkpoint of ``variant`` with ``v_layers`` layers
    at ``image_size`` px (runs in a worker process)."""
    import dataclasses

    from clip_tpu_torch import synth

    cut = f"{variant}-{image_size}px-{v_layers}l"
    synth.VARIANTS[cut] = dataclasses.replace(synth.VARIANTS[variant], v_layers=v_layers,
                                              image_size=image_size)
    return synth.make_synthetic_gguf(path, cut, ftype="q4_0", towers="vision", seed=0)


def write_checkpoints(pool, tmp: str) -> dict:
    """Submit the path phases' checkpoints to ``pool`` (the largest first);
    returns futures of their paths."""
    from clip_tpu_torch.synth import make_synthetic_gguf

    futs = {name: pool.submit(write_cut, os.path.join(tmp, f"{name}_q4_0.gguf"), *spec)
            for name, spec in CUT_PATHS.items()}
    futs.update({name: pool.submit(make_synthetic_gguf,
                                   os.path.join(tmp, f"vit-b-32_{name}.gguf"), "ViT-B/32",
                                   ftype=ft, towers=towers, seed=0)
                 for name, (ft, towers) in PATHS.items()})
    return futs


def _proj(rows: int) -> str:
    """The wrapper of a W8 layer projection that keeps its q4_0 source: the
    dequant-GEMM on the source at 2048 rows or fewer, else the int8 GEMM."""
    return "qmatmul_q4" if rows <= 2048 else "w8a8_pre"


def layer_launches(attn: str, mlp: str, rows: int) -> dict:
    """Launches of the ``PATH_WRAPPERS`` one layer over ``rows`` rows implies,
    by the route of its attention and MLP halves.  The block chains launch
    ``lnq`` themselves, ``mlp_lnq`` and ``mlp_lnq_stream`` launch
    ``ctt_gemm_gq`` (counted in ``gemm_gq``), and ``mlp_gq`` launches
    ``gemm_gq`` and ``w8a8_pre``, so those count too."""
    n = dict.fromkeys(PATH_WRAPPERS, 0)
    steps = {"block": ["attn_block", "lnq"],
             "staged": ["lnq", "w8a8_pre", "mha_qkv", _proj(rows)],
             "no_lnq": [_proj(rows), "mha_qkv", _proj(rows)],
             "i8_quant_o": ["lnq", "gemm_gq", "mha_qkv_i8"],
             "i8": ["lnq", "gemm_gq", "mha_qkv_i8", _proj(rows)],
             "stream": ["attn_block_stream", "lnq"],
             "dense": ["mha_qkv"]}[attn]
    steps += {"block": ["mlp_lnq", "lnq", "gemm_gq"], "staged": ["lnq", "gemm_gq"],
              "gq": ["mlp_gq", "gemm_gq", "w8a8_pre"],
              "stream": ["mlp_lnq_stream", "lnq", "gemm_gq"], "dense": []}[mlp]
    for w in steps:
        n[w] += 1
    return n


def expected_launches(eng, calls) -> dict:
    """Launches a run of tower ``calls`` implies: each call is (tower, rows,
    attention route, MLP route) and runs every layer of its tower on that
    route, then its block-quantized projection through the kernel of its
    format (each call's projection has 64 rows or fewer)."""
    from clip_tpu_torch.ops.qtensor import QTensor

    cfg = {"vision": eng.config.vision, "text": eng.config.text}
    exp = dict.fromkeys(PATH_WRAPPERS, 0)
    for tower, rows, attn, mlp in calls:
        for k, v in layer_launches(attn, mlp, rows).items():
            exp[k] += v * cfg[tower].n_layer
        proj = eng.params[tower]["proj"]
        if isinstance(proj, QTensor):
            bits = 4 if proj.is_packed4 else 5 if proj.is_packed5 else 8
            exp[f"qmatmul_q{bits}"] += 1
    return exp


def _b32_calls(attn: str, mlp: str) -> list:
    """A two-tower ViT-B/32 drive: 64 images (rows 64 x 50), 8 prompts (8 x
    80), then the zero-shot labeling: 1 image (padded once to S = 56) and 3
    labels (bucket 4)."""
    return [("vision", 64 * 50, attn, mlp), ("text", 8 * 80, attn, mlp),
            ("vision", 56, attn, mlp), ("text", 4 * 80, attn, mlp)]


# path phase -> (checkpoint, engine arguments, drives); a drive is (images,
# with text and zero-shot labeling, tower calls it implies)
PATH_RUNS = {
    "q4_0": ("q4_0", {}, {"main": (64, True, _b32_calls("block", "block"))}),
    "f16": ("f16", {}, {"main": (64, True, _b32_calls("dense", "dense"))}),
    "q5_1": ("q5_1", {}, {"main": (64, False, [("vision", 3200, "block", "block")])}),
    "q8_0": ("q8_0", {}, {"main": (64, False, [("vision", 3200, "block", "block")])}),
    # ViT-H/14 (S 257 padded to 264): resident attention block, staged MLP
    "h14_staged_mlp": ("h14", {}, {"main": (64, False,
                                            [("vision", 64 * 264, "block", "staged")])}),
    # ViT-L/14-336 (S 577 padded to 584): staged attention, whole-MLP block;
    # its o projection on the q4_0 source at 584 and 1168 rows, int8 at 2336
    "l14_336_staged_attn": ("l14_336", {}, {
        f"b{n}": (n, False, [("vision", n * 584, "staged", "block")]) for n in (1, 2, 4)}),
    # lnq_fuse off: LN ahead of the projections, the up_gq MLP (mlp_gq)
    "b32_up_gq": ("q4_0", dict(lnq_fuse=False),
                  {"main": (64, True, _b32_calls("no_lnq", "gq"))}),
    # ViT-B/16 at 384 px (S 577 padded to 584), all 12 layers: the streamed
    # attention block at every batch, the whole-MLP block
    "b16_384_stream_attn": ("b16_384", {}, {
        f"b{n}": (n, False, [("vision", n * 584, "stream", "block")]) for n in (1, 8)}),
}


def run_path(name: str, path: str, engine_kw: dict, drives: dict) -> dict:
    """One path phase: the engine end to end on ``path``, each drive with
    the launch counters set to 0 just before and read just after, then
    against the same engine on its plain versions in float32."""
    import torch

    from clip_tpu_torch import ops
    from clip_tpu_torch.engine import ClipEngine

    t0 = time.perf_counter()
    eng = ClipEngine(path, verbosity=0, **engine_kw)
    assert eng.device.type == "cuda" and eng.compute_dtype == torch.bfloat16
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    images = [(rng.random((256, 320, 3)) * 255).astype(np.uint8) for _ in range(64)]
    prompts = ["a photo of a cat", "a photo of a dog", "a red apple", "the white cat",
               "an apple", "a dog", "a photo of the red dog", "white"]
    labels = ["cat", "dog", "apple"]

    def drive(e, n_images: int, text: bool):
        out = {"image": e.encode_image(images[:n_images])}
        if text:
            out["text"] = e.encode_text(prompts)
            out["zsl"] = e.zero_shot_label_image(images[0], labels)
        return out

    res = dict(engine=eng, route=eng.route, load_s=load_s, launches={}, expect={},
               run_s={})
    got = {}
    for label, (n_images, text, calls) in drives.items():
        ops.reset_launches()
        t1 = time.perf_counter()
        got[label] = drive(eng, n_images, text)
        torch.cuda.synchronize()
        res["run_s"][label] = time.perf_counter() - t1
        launches = {k: v for k, v in ops.launches().items() if k in PATH_WRAPPERS}
        expect = expected_launches(eng, calls)
        assert launches == expect, f"{name} {label}: launches {launches}, expected {expect}"
        res["launches"][label], res["expect"][label] = launches, expect
        res.setdefault("gemm_i8_launches", {})[label] = ops.launches()["gemm_i8"]
        for tower in ("image", "text"):
            if tower in got[label]:
                emb = got[label][tower]
                assert np.isfinite(emb).all(), f"{name} {label}: {tower} embeddings not finite"
                norms = np.linalg.norm(emb, axis=1)
                assert np.abs(norms - 1).max() < 1e-2, f"{name} {label}: {tower} norms {norms}"
    if name == "f16":
        # the dense route's bf16 cuBLAS GEMMs with split-K reductions kept in
        # f32: the same images once more, and the largest change
        flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        try:
            again = eng.encode_image(images)
        finally:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        res["bf16_reduction_off_max_diff"] = float(np.abs(again - got["main"]["image"]).max())

    t2 = time.perf_counter()
    ref = ClipEngine(path, compute_dtype="float32", kernels=False, verbosity=0, **engine_kw)
    for label, (n_images, text, _) in drives.items():
        want = drive(ref, n_images, text)
        for tower in ("image", "text"):
            if tower in got[label]:
                c = float((got[label][tower] * want[tower]).sum(1).min())
                assert c > 0.999, f"{name} {label}: {tower} vs plain f32: min cos {c}"
                res[f"{label}_{tower}_min_cos"] = c
        if text:
            res[f"{label}_zsl"] = [got[label]["zsl"][1].tolist(), got[label]["zsl"][0].tolist()]
            res[f"{label}_zsl_plain"] = [want["zsl"][1].tolist(), want["zsl"][0].tolist()]
    res["plain_s"] = time.perf_counter() - t2
    del ref
    torch.cuda.empty_cache()
    return res


def attn_i8_stacks(engines: dict) -> dict:
    """Phase: two layers on the ``attn_i8`` route (``run_blocks(attn_block=
    False, attn_i8=True)``) at three geometries, over the loaded engines'
    layer weights (q4_0 sources kept): ViT-B/32 vision (B 64, S 50), its text
    tower (B 8, S 80, causal) and ViT-L/14-336 (B 2, S 584, valid 577).
    Launches counted per stack; per-row cos against the plain float32
    stack."""
    import torch

    from clip_tpu_torch import ops
    from clip_tpu_torch.models.transformer import run_blocks

    stacks = {"b32_vision": ("q4_0", "vision", 64, 50, None, False, "i8_quant_o"),
              "b32_text": ("q4_0", "text", 8, 80, None, True, "i8_quant_o"),
              "l14_336": ("l14_336_staged_attn", "vision", 2, 584, 577, False, "i8")}
    rng = np.random.default_rng(5)
    out = {}
    for name, (path, tower, b, s, vl, causal, attn) in stacks.items():
        eng = engines[path]
        cfg = getattr(eng.config, tower)
        layers = {k: v[:2] for k, v in eng.params[tower]["layers"].items()}
        x = rng.normal(0, 1, (b, s, cfg.hidden_size)).astype(np.float32)
        if vl is not None:
            x[:, vl:] = 0.0  # the pad rows of the vision tower's pad-once
        x = torch.from_numpy(x).cuda().to(torch.bfloat16)
        kw = dict(n_head=cfg.n_head, eps=cfg.eps, use_gelu=eng.config.use_gelu, causal=causal,
                  valid_len=vl, attn_block=False, attn_i8=True)
        ops.reset_launches()
        got = run_blocks(x, layers, **kw)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches().items() if k in PATH_WRAPPERS}
        expect = {k: 2 * v for k, v in layer_launches(attn, "block", b * s).items()}
        assert launches == expect, f"attn_i8 {name}: launches {launches}, expected {expect}"
        want = run_blocks(x.float(), layers, kernels=False, **kw)
        real = slice(0, vl or s)
        g, w = got[:, real].float(), want[:, real]
        row_cos = (g * w).sum(-1) / (g.norm(dim=-1) * w.norm(dim=-1))
        c = float(row_cos.min())
        assert bool(torch.isfinite(got).all()) and c > 0.999, f"attn_i8 {name}: min cos {c}"
        out[name] = dict(shape=(b, s, cfg.hidden_size), valid_len=vl, causal=causal,
                         launches=launches, min_row_cos=c,
                         max_abs_err=float((g - w).abs().max()))
    return out


def long_sequence(eng) -> dict:
    """Phase: two W8A8 layers at ViT-L/14-336's widths and its unpadded
    S = 577 through ``run_blocks``, over the L/14-336 engine's first two
    layers: the flat gate fails at 577, so the route is the staged one (as
    the JAX package's would be at that S), with the o projection on the q4_0
    source; kernels against the plain versions."""
    import torch

    from clip_tpu_torch import ops
    from clip_tpu_torch.models.transformer import run_blocks

    b, s, n_layer = 2, 577, 2
    cfg = eng.config.vision
    layers = {k: v[:n_layer] for k, v in eng.params["vision"]["layers"].items()}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (b, s, cfg.hidden_size)).astype(np.float32)).cuda()
    x = x.to(torch.bfloat16)
    kw = dict(n_head=cfg.n_head, eps=cfg.eps, use_gelu=False)
    ops.reset_launches()
    got = run_blocks(x, layers, **kw)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launches().items() if k in PATH_WRAPPERS}
    want = run_blocks(x.float(), layers, kernels=False, **kw)
    c = cos(got, want)
    assert bool(torch.isfinite(got).all()) and c > 0.999, f"L/14-336 stack: cos {c}"
    expect = {k: n_layer * v for k, v in layer_launches("staged", "block", b * s).items()}
    assert launches == expect, f"L/14-336 stack: launches {launches}, expected {expect}"
    return dict(shape=(b, s, cfg.hidden_size, cfg.n_head, cfg.n_intermediate), layers=n_layer,
                cos=c, launches=launches, max_abs_err=float((got.float() - want).abs().max()))


def check_staged_kernels(device) -> dict:
    """Phase 3b: the wrappers of the staged routes against their plain
    versions on the card, at the shapes the new paths give them, and device
    preprocessing against the host path.  Returns the inputs and errors
    that the timing phase uses."""
    import torch

    from clip_tpu_torch.ops import actquant as aq
    from clip_tpu_torch.ops import attention as at
    from clip_tpu_torch.ops.device_preprocess import device_preprocess
    from clip_tpu_torch.preprocess import preprocess_batch

    rng = np.random.default_rng(4)
    out: dict = {"args": {}}
    fails: list[str] = []

    def expect(ok: bool, msg: str) -> None:
        if not ok:
            fails.append(msg)

    def codes_close(name, codes, sx, pc, psx, rtol) -> int:
        """Row-quant outputs: scales within ``rtol``, codes within 1 and all
        but a 1e-4 share equal.  Records the largest difference of the
        dequantized values (codes x scales) as ``<name>_err``; returns the
        number of codes that differ."""
        sx, psx = sx.reshape(-1), psx.reshape(-1)
        expect(bool(torch.allclose(sx, psx, rtol=rtol, atol=0)),
               f"{name}: scales differ by {float(((sx - psx) / psx).abs().max())}")
        codes, pc = codes.reshape(sx.numel(), -1), pc.reshape(sx.numel(), -1)
        diff = (codes.int() - pc.int()).abs()
        n = int((diff > 0).sum())
        expect(int(diff.max()) <= 1 and n <= 1e-4 * diff.numel(),
               f"{name}: {n} codes differ, by up to {int(diff.max())}")
        deq = (codes.float() * sx[:, None] - pc.float() * psx[:, None]).abs().max()
        out[name.replace(" ", "_") + "_err"] = float(deq)
        return n

    def x_bf16(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device).bfloat16()

    # lnq at ViT-H/14's MLP input (64 x 264 rows, H 1280) and ViT-L/14-336's
    # attention input (2 x 584 rows, H 1024)
    for name, (rows, h) in {"h14": (64 * 264, 1280), "l14_336": (2 * 584, 1024)}.items():
        x = x_bf16(rows, h)
        w, b = vec(rng, h, device, 1.0, 0.1), vec(rng, h, device, 0.0, 0.1)
        codes, sx = aq.lnq(x, w, b, 1e-5)
        pc, psx = aq.lnq_plain(x, w, b, 1e-5)
        out[f"lnq_{name}_mismatch"] = codes_close(f"lnq {name}", codes, sx, pc, psx, 1e-6)
        out["args"][f"lnq_{name}"] = (x, w, b)
        if name == "h14":
            c_h14, s_h14 = codes, sx
    # gemm_gq: gelu_quick at ViT-H/14's up GEMM, none at ViT-B/32's qkv GEMM
    up8, upws = w8(rng, 5120, 1280, device)
    upb = vec(rng, 5120, device)
    gq = aq.gemm_gq(c_h14, s_h14, up8, upws, upb, "gelu_quick")
    gq_p = aq.gemm_gq_plain(c_h14, s_h14, up8, upws, upb, "gelu_quick")
    out["gemm_gq_h14_mismatch"] = codes_close("gemm_gq h14", *gq, *gq_p, 1e-5)
    chain = aq.requant(aq.gemm_i8(c_h14, up8, s_h14, upws, upb, aq.GELU_QUICK))
    expect(torch.equal(gq[0], chain[0]) and torch.equal(gq[1], chain[1]),
           "gemm_gq h14: not bit-equal to requant(gemm_i8(...))")
    c2_h14, s2_h14 = gq
    out["args"]["gemm_gq_h14"] = (c_h14, s_h14, up8, upws, upb, "gelu_quick")
    c_b32, s_b32 = aq.lnq(x_bf16(64 * 50, 768), vec(rng, 768, device, 1.0, 0.1),
                          vec(rng, 768, device), 1e-5)
    qw8, qws = w8(rng, 2304, 768, device)
    qb = vec(rng, 2304, device)
    gq = aq.gemm_gq(c_b32, s_b32, qw8, qws, qb, "none")
    gq_p = aq.gemm_gq_plain(c_b32, s_b32, qw8, qws, qb, "none")
    out["gemm_gq_b32_none_mismatch"] = codes_close("gemm_gq b32 none", *gq, *gq_p, 1e-6)
    chain = aq.requant(aq.gemm_i8(c_b32, qw8, s_b32, qws, qb, aq.BIAS_F32))
    expect(torch.equal(gq[0], chain[0]) and torch.equal(gq[1], chain[1]),
           "gemm_gq b32 none: not bit-equal to requant(gemm_i8(...))")
    out["args"]["gemm_gq_b32_none"] = (c_b32, s_b32, qw8, qws, qb, "none")
    # w8a8_pre: ViT-H/14's down GEMM (over the gemm_gq codes) and
    # ViT-L/14-336's qkv GEMM; the int32 accumulator and the rescale are
    # exact, so bit-equal
    dn8, dnws = w8(rng, 1280, 5120, device)
    l_codes, l_sx = aq.lnq(*out["args"]["lnq_l14_336"], 1e-5)
    lq8, lqws = w8(rng, 3072, 1024, device)
    for name, args in {"h14_down": (c2_h14, s2_h14, dn8, dnws),
                       "l14_336_qkv": (l_codes, l_sx, lq8, lqws)}.items():
        got, want = aq.w8a8_pre(*args), aq.w8a8_pre_plain(*args)
        expect(torch.equal(got, want), f"w8a8_pre {name}: max diff "
               f"{float((got.float() - want.float()).abs().max())}")
        out["args"][f"w8a8_pre_{name}"] = args
    # mlp_gq at ViT-B/32's MLP widths (64 x 50 rows)
    mu8, muws = w8(rng, 3072, 768, device)
    md8, mdws = w8(rng, 768, 3072, device)
    margs = (c_b32, s_b32, mu8, muws, vec(rng, 3072, device), md8, mdws)
    got, want = aq.mlp_gq(*margs), aq.mlp_gq_plain(*margs, out_dtype=torch.float32)
    c = cos(got, want)
    expect(c > 0.999 and bool(torch.isfinite(got).all()), f"mlp_gq b32: cos {c}")
    out["mlp_gq_b32_cos"] = c
    out["mlp_gq_b32_err"] = float((got.float() - want).abs().max())
    out["args"]["mlp_gq_b32"] = margs
    # mha_qkv_i8 at the attn_i8 stacks' shapes, both output forms
    for name, (b, s, nh, dh, vl, causal) in {
            "vision": (64, 50, 12, 64, None, False), "text": (8, 80, 8, 64, None, True),
            "l14_336": (2, 584, 16, 64, 577, False)}.items():
        codes = torch.from_numpy(rng.integers(-127, 128, (b, s, 3 * nh * dh), dtype=np.int8))
        codes = codes.to(device)
        scales = torch.from_numpy(rng.uniform(0.01, 0.03, (b, s)).astype(np.float32)).to(device)
        kw = dict(n_head=nh, scale=dh ** -0.5, causal=causal, valid_len=vl)
        got = at.mha_qkv_i8(codes, scales, **kw).float()
        want = at.mha_qkv_i8_plain(codes, scales, **kw).float()
        err = float((got - want).abs().max())
        c = cos(got, want)
        expect(c > 0.9999 and bool(torch.allclose(got, want, rtol=1.6e-2, atol=1e-3)),
               f"mha_qkv_i8 {name}: cos {c}, max err {err}")
        out[f"mha_qkv_i8_{name}_err"] = err
        qc, qs = at.mha_qkv_i8(codes, scales, quant_out=True, **kw)
        pqc, pqs = at.mha_qkv_i8_plain(codes, scales, quant_out=True, **kw)
        out[f"mha_qkv_i8_{name}_quant_mismatch"] = codes_close(
            f"mha_qkv_i8 {name} quant_out", qc, qs, pqc, pqs, 1e-4)
        out["args"][f"mha_qkv_i8_{name}"] = (codes, scales, kw)
    # device preprocessing against the host path, in pixel space
    mean = np.array([0.48145466, 0.4578275, 0.40821073])
    std = np.array([0.26862954, 0.26130258, 0.27577711])
    imgs = (np.random.default_rng(6).random((8, 256, 320, 3)) * 255).astype(np.uint8)
    dev = device_preprocess(imgs, 224, mean, std, device=device).cpu().numpy()
    host = preprocess_batch(list(imgs), 224, mean, std)
    out["device_preprocess_err"] = float(np.abs(dev - host).max())
    expect(out["device_preprocess_err"] < 5e-4,
           f"device preprocessing: max err {out['device_preprocess_err']}")
    if fails:
        raise AssertionError("staged kernel checks failed:\n  " + "\n  ".join(fails))
    torch.cuda.synchronize()
    return out


def check_stream_kernels(device) -> dict:
    """Phase 4b: the kernels of the streamed routes and the last three TPU
    kernels against their plain versions on the card.  Returns the inputs
    and errors that the timing phase uses."""
    import torch

    from clip_tpu_torch.ops import actquant as aq
    from clip_tpu_torch.ops import attention as at

    rng = np.random.default_rng(9)
    out: dict = {"args": {}}
    fails: list[str] = []

    def expect(ok: bool, msg: str) -> None:
        if not ok:
            fails.append(msg)

    def close(name, got, want, min_cos=0.999, **tol) -> None:
        """cos > ``min_cos``, finite, and allclose at ``tol`` where given;
        records the largest difference as ``<name>_err``."""
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        c = cos(got, want)
        ok = c > min_cos and bool(torch.isfinite(got).all())
        if tol:
            ok = ok and bool(torch.allclose(got, want, **tol))
        expect(ok, f"{name}: cos {c}, max err {err}")
        out[f"{name}_err"], out[f"{name}_cos"] = err, c

    def equal(name, got, want) -> None:
        expect(torch.equal(got, want), f"{name}: not bit-equal, max diff "
               f"{float((got.double() - want.double()).abs().max())}")

    def codes_close(name, codes, sx, pc, psx, rtol) -> None:
        """Row-quant outputs: scales within ``rtol``, codes within 1 and all
        but a 1e-4 share equal; records the largest difference of the
        dequantized values as ``<name>_err``."""
        groups = psx.numel() // psx.shape[0]
        expect(bool(torch.allclose(sx, psx, rtol=rtol, atol=0)),
               f"{name}: scales differ by {float(((sx - psx) / psx).abs().max())}")
        diff = (codes.int() - pc.int()).abs()
        n = int((diff > 0).sum())
        expect(int(diff.max()) <= 1 and n <= 1e-4 * diff.numel(),
               f"{name}: {n} codes differ, by up to {int(diff.max())}")
        sxe = sx.reshape(sx.shape[0], groups).repeat_interleave(codes.shape[1] // groups, 1)
        psxe = psx.reshape(sx.shape[0], groups).repeat_interleave(codes.shape[1] // groups, 1)
        out[f"{name}_err"] = float((codes.float() * sxe - pc.float() * psxe).abs().max())
        out[f"{name}_mismatch"] = n

    def x_bf16(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device).bfloat16()

    # row 8: ViT-B/16 at 384 px (B 1, S 584, valid 577, 12 heads: hg 4) and
    # ViT-H/14 width at 280 px (B 2, S 408, 16 heads of 80: hg 8)
    for name, (b, s, h, nh, vl, hg) in {"b16_384": (1, 584, 768, 12, 577, 4),
                                        "h14_408": (2, 408, 1280, 16, None, 8)}.items():
        wt = block_weights(rng, h, 4 * h, device)
        x = x_bf16(b, s, h)
        args = (x, wt["lnw"], wt["lnb"], wt["qw8"], wt["qws"], wt["qb"], wt["ow8"], wt["ows"],
                wt["ob"])
        kw = dict(n_head=nh, scale=(h // nh) ** -0.5, eps=1e-5, valid_len=vl, residual=True)
        expect(at.stream_heads(b, s, h, 3 * h, h, nh) == hg, f"attn_block_stream {name}: hg")
        got = at.attn_block_stream(*args, **kw)
        close(f"attn_block_stream_{name}", got, at.attn_block_stream_plain(*args, **kw))
        out["args"][f"attn_block_stream_{name}"] = (args, kw)
        # one head group: the full-row requant and one o GEMM group, which is
        # the resident block's chain bit for bit
        one = at.attn_block_stream(*args, **{**kw, "hg": nh})
        kw_ab = {k: v for k, v in kw.items() if k != "residual"}
        equal(f"attn_block_stream {name} one group vs attn_block", one,
              at.attn_block(*args, **kw_ab))
    # the grouped requant alone, at the B/16-384 attention output
    (x, lnw, lnb, qw8, qws, qb, _, _, _), kw = out["args"]["attn_block_stream_b16_384"]
    c1, s1 = aq.lnq(x.reshape(584, 768), lnw, lnb, 1e-5)
    att = at.attention_heads(aq.gemm_i8(c1, qw8, s1, qws, qb, aq.BIAS), 1, 584, 12,
                             kw["scale"], valid_len=577)
    codes_close("requant_group256", *aq.requant(att, group=256),
                *aq.requant_plain(att, group=256), 1e-6)

    # row 9 at ViT-H/14's MLP (64 x 264 rows, 1280 x 5120)
    rows, h, f = 64 * 264, 1280, 5120
    wt = block_weights(rng, h, f, device)
    x = x_bf16(rows, h)
    margs = (x, wt["lnw"], wt["lnb"], wt["up8"], wt["upws"], wt["upb"], wt["dn8"], wt["dnws"],
             wt["dnb"])
    resident = aq.mlp_lnq(*margs, eps=1e-5)
    for name, kw in {"exact": dict(exact=True), "chunks8": dict(exact=False)}.items():
        kw = dict(eps=1e-5, residual=True, **kw)
        got = aq.mlp_lnq_stream(*margs, **kw)
        close(f"mlp_lnq_stream_h14_{name}", got, aq.mlp_lnq_stream_plain(*margs, **kw))
        out["args"][f"mlp_lnq_stream_h14_{name}"] = (margs, kw)
    equal("mlp_lnq_stream exact vs mlp_lnq",
          aq.mlp_lnq_stream(*margs, eps=1e-5, residual=True), resident)
    equal("mlp_lnq_stream one chunk vs mlp_lnq",
          aq.mlp_lnq_stream(*margs, eps=1e-5, residual=True, exact=False, n_chunks=1), resident)
    # the grouped GEMM epilogue alone over the 8 chunks' codes: bit-equal to
    # its plain version; with one group bit-equal to the residual epilogue
    c1, s1 = aq.lnq(x, wt["lnw"], wt["lnb"], 1e-5)
    y = aq.gemm_i8(c1, wt["up8"], s1, wt["upws"], wt["upb"], aq.GELU_QUICK)
    c2, s2 = aq.requant(y, group=640)
    codes_close("requant_group640", c2, s2, *aq.requant_plain(y, group=640), 1e-6)
    gc, gs = aq._gemm_gq(c1, s1, wt["up8"], wt["upws"], wt["upb"], "gelu_quick", 640)
    equal("gemm_gq chunks of 640 vs requant(gemm_i8(...))", gc, c2)
    equal("gemm_gq chunks of 640 scales", gs, s2)
    gargs = (c2, wt["dn8"], s2, wt["dnws"], wt["dnb"], aq.GROUPED)
    equal("gemm_i8 grouped 8 x 640", aq.gemm_i8(*gargs, resid=x, group=640),
          aq.gemm_i8_plain(*gargs, resid=x, group=640))
    equal("gemm_i8 grouped pre-bias", aq.gemm_i8(c2, wt["dn8"], s2, wt["dnws"], None,
                                                 aq.GROUPED, group=640),
          aq.gemm_i8_plain(c2, wt["dn8"], s2, wt["dnws"], None, aq.GROUPED, group=640))
    c3, s3 = aq.requant(y)
    equal("gemm_i8 one group vs resid", aq.gemm_i8(c3, wt["dn8"], s3[:, None], wt["dnws"],
                                                   wt["dnb"], aq.GROUPED, resid=x, group=f),
          aq.gemm_i8(c3, wt["dn8"], s3, wt["dnws"], wt["dnb"], aq.RESID, resid=x))

    # row 11 at the H/14 up GEMM's output [16896, 5120], each act, f32 in;
    # bf16 in once
    yq = torch.from_numpy(rng.normal(0, 2, (rows, f)).astype(np.float32)).to(device)
    for act in ("gelu_quick", "gelu_tanh", "none"):
        codes_close(f"actq_{act}", *aq.actq(yq, act), *aq.actq_plain(yq, act), 1e-6)
    codes_close("actq_gelu_quick_bf16", *aq.actq(yq.bfloat16(), "gelu_quick"),
                *aq.actq_plain(yq.bfloat16(), "gelu_quick"), 1e-6)
    out["args"]["actq"] = yq

    # row 13 at ViT-B/32 vision [64, 50, 768] and causal text [8, 77, 512],
    # bf16 and f32
    for name, (b, s, h, nh, causal) in {"vision": (64, 50, 768, 12, False),
                                        "text": (8, 77, 512, 8, True)}.items():
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (x_bf16(b, s, h).to(dt) for _ in range(3))
            kw = dict(n_head=nh, scale=(h // nh) ** -0.5, causal=causal)
            got = at.mha(q, k, v, **kw)
            expect(got.dtype == dt, f"mha {name}: dtype {got.dtype}")
            tol = dict(rtol=1.6e-2, atol=1e-3) if dt == torch.bfloat16 else dict(rtol=0,
                                                                                 atol=1e-4)
            tag = "bf16" if dt == torch.bfloat16 else "f32"
            close(f"mha_{name}_{tag}", got, at.mha_plain(q, k, v, **kw), 0.9999, **tol)
            out["args"][f"mha_{name}_{tag}"] = (q, k, v, kw)

    # row 12 at ViT-B/32 vision [64, 50, 768] and causal text [8, 80, 512]
    for name, (b, s, h, nh, causal) in {"vision": (64, 50, 768, 12, False),
                                        "text": (8, 80, 512, 8, True)}.items():
        wt = block_weights(rng, h, 4 * h, device)
        x = x_bf16(b, s, h)
        largs = (x, wt["lnw"], wt["lnb"], wt["qw8"], wt["qws"], wt["qb"], wt["ow8"], wt["ows"],
                 wt["ob"], vec(rng, h, device, 1.0, 0.1), vec(rng, h, device), wt["up8"],
                 wt["upws"], wt["upb"], wt["dn8"], wt["dnws"], wt["dnb"])
        kw = dict(n_head=nh, scale=(h // nh) ** -0.5, eps=1e-5, causal=causal)
        got = at.layer_block(*largs, **kw)
        close(f"layer_block_{name}", got, at.layer_block_plain(*largs, **kw))
        xm = at.attn_block(*largs[:9], **kw).reshape(b * s, h)
        equal(f"layer_block {name} vs attn_block + mlp_lnq", got,
              aq.mlp_lnq(xm, *largs[9:], eps=1e-5).reshape(b, s, h))
        out["args"][f"layer_block_{name}"] = (largs, kw)
    if fails:
        raise AssertionError("stream kernel checks failed:\n  " + "\n  ".join(fails))
    torch.cuda.synchronize()
    return out


def mlp_stream_path(eng) -> dict:
    """Phase: the cut ViT-H/14 tower (8 layers) at B = 64 through
    ``encode_image(..., mlp_stream=True)`` with the launch counters set to 0
    just before and read just after: every MLP on the streamed block (row
    9, ``exact=True``).  Its embeddings must equal the default staged
    route's on the same pixels bit for bit.  Both are timed."""
    import torch

    from clip_tpu_torch import ops
    from clip_tpu_torch.models.vision import encode_image

    cfg = eng.config.vision
    px = np.random.default_rng(8).standard_normal((64, cfg.image_size, cfg.image_size, 3),
                                                  dtype=np.float32)
    px = torch.from_numpy(px).cuda().bfloat16()

    def tower(**flags):
        with torch.inference_mode():
            return encode_image(eng.params["vision"], cfg, px, use_gelu=eng.config.use_gelu,
                                compute_dtype=torch.bfloat16, **eng.tower_flags(), **flags)

    ops.reset_launches()
    got = tower(mlp_stream=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launches().items() if k in PATH_WRAPPERS}
    expect = expected_launches(eng, [("vision", 64 * 264, "block", "stream")])
    assert launches == expect, f"h14 mlp_stream: launches {launches}, expected {expect}"
    want = tower()
    assert bool(torch.isfinite(got).all()), "h14 mlp_stream: embeddings not finite"
    assert torch.equal(got, want), ("h14 mlp_stream: not bit-equal to the default route, max "
                                    f"diff {float((got.float() - want.float()).abs().max())}")
    stream_ms = [cuda_ms(lambda: tower(mlp_stream=True), iters=3, warmup=1 if i == 0 else 0)
                 for i in range(3)]
    default_ms = [cuda_ms(tower, iters=3, warmup=1 if i == 0 else 0) for i in range(3)]
    return dict(shape=(64, 264, cfg.hidden_size, cfg.n_intermediate), layers=cfg.n_layer,
                launches=launches, bit_equal_to_default=True,
                tower_median_ms=statistics.median(stream_ms), tower_runs_ms=stream_ms,
                default_route_median_ms=statistics.median(default_ms),
                default_route_runs_ms=default_ms)


def qmatmul_bytes(m: int, w) -> int:
    """Compulsory bytes of ``x [m, K] bf16 @ dequant(w)[N, K].T -> bf16``:
    the activations, the packed weight fields, the output."""
    n, k = w.shape
    fields = [w.q, w.d] + [t for t in (w.m, w.hb) if t is not None]
    return m * k * 2 + sum(t.numel() * t.element_size() for t in fields) + m * n * 2


def kernel_bounds(chk: dict) -> dict:
    b, s, h, nh, f = chk["vision"]["shape"]
    rows, dh = b * s, h // nh
    vecs = lambda n: 4 * n  # noqa: E731  (f32 vector bytes)
    out = {
        "attn_block": bound(
            2 * rows * h * 2 + 4 * h * h + 2 * vecs(h) + 2 * vecs(3 * h) + 2 * vecs(h),
            int8_ops=2 * rows * 4 * h * h, bf16_flops=4 * b * nh * s * s * dh),
        "mlp_lnq": bound(2 * rows * h * 2 + 2 * f * h + 2 * vecs(h) + 2 * vecs(f) + 2 * vecs(h),
                         int8_ops=2 * rows * 2 * f * h),
    }
    for name in ("vision", "text"):
        qkv, kw = chk["mha_args"][name]
        b, s, h3 = qkv.shape
        out[f"mha_qkv_{name}"] = bound(b * s * h3 * 2 + b * s * h3 // 3 * 2,
                                       bf16_flops=4 * b * s * s * h3 // 3)
    for fmt, (xq, wq) in chk["qmatmul_args"].items():
        m, k = xq.shape
        out[f"qmatmul_{fmt}"] = bound(qmatmul_bytes(m, wq), bf16_flops=2 * m * wq.shape[0] * k)
    return out


def staged_bounds(schk: dict) -> dict:
    """Bounds of the staged routes' kernels at the shapes they were timed at:
    each input read once, each output written once, int8 products at the
    int8 peak and the p.V products at the bf16 peak."""
    a = schk["args"]
    x, _, _ = a["lnq_h14"]
    rows, h = x.shape
    out = {"lnq": bound(rows * h * 2 + rows * h + 4 * rows + 8 * h)}
    codes, _, w8_, _, _, _ = a["gemm_gq_h14"]
    m, k = codes.shape
    n = w8_.shape[0]
    out["gemm_gq"] = bound(m * k + 4 * m + n * k + 8 * n + m * n + 4 * m,
                           int8_ops=2 * m * n * k)
    codes, _, up8, _, _, _, _ = a["mlp_gq_b32"]
    m, h = codes.shape
    n = up8.shape[0]
    out["mlp_gq"] = bound(m * h + 4 * m + 2 * n * h + 8 * n + 4 * h + 2 * m * h,
                          int8_ops=4 * m * n * h)
    codes, _, kw = a["mha_qkv_i8_vision"]
    b, s, h3 = codes.shape
    out["mha_qkv_i8"] = bound(b * s * h3 + 4 * b * s + 2 * b * s * h3 // 3,
                              int8_ops=2 * b * s * s * h3 // 3, bf16_flops=2 * b * s * s * h3 // 3)
    return out


def staged_timing(schk: dict, engines: dict) -> dict:
    """Phase: device times (CUDA-graph replay) of the staged routes' kernels
    and their plain versions at the shapes the new paths give them, SDPA on
    the dequantized bf16 q, k, v beside ``mha_qkv_i8`` (the nearest single
    call; not the same function), and the cut towers: ViT-H/14 at B = 64,
    ViT-L/14-336 at B = 1 and 4, whole and per layer."""
    import torch

    from clip_tpu_torch.models.transformer import run_blocks
    from clip_tpu_torch.models.vision import encode_image, pad_once
    from clip_tpu_torch.ops import actquant as aq
    from clip_tpu_torch.ops import attention as at

    a = schk["args"]
    res: dict = {}
    for name in ("lnq_h14", "lnq_l14_336"):
        x, w, b = a[name]
        res[f"{name}_ms"] = graph_ms(lambda: aq.lnq(x, w, b, 1e-5))
    x, w, b = a["lnq_h14"]
    res["lnq_h14_plain_ms"] = graph_ms(lambda: aq.lnq_plain(x, w, b, 1e-5), iters=10)
    for name in ("gemm_gq_h14", "gemm_gq_b32_none"):
        res[f"{name}_ms"] = graph_ms(lambda: aq.gemm_gq(*a[name]))
    res["gemm_gq_h14_plain_ms"] = graph_ms(lambda: aq.gemm_gq_plain(*a["gemm_gq_h14"]), iters=5)
    for name in ("w8a8_pre_h14_down", "w8a8_pre_l14_336_qkv"):
        res[f"{name}_ms"] = graph_ms(lambda: aq.w8a8_pre(*a[name]))
    res["mlp_gq_b32_ms"] = graph_ms(lambda: aq.mlp_gq(*a["mlp_gq_b32"]))
    res["mlp_gq_b32_plain_ms"] = graph_ms(lambda: aq.mlp_gq_plain(*a["mlp_gq_b32"]), iters=10)
    for name in ("vision", "text", "l14_336"):
        codes, scales, kw = a[f"mha_qkv_i8_{name}"]
        res[f"mha_qkv_i8_{name}_ms"] = graph_ms(lambda: at.mha_qkv_i8(codes, scales, **kw))
        res[f"mha_qkv_i8_{name}_quant_out_ms"] = graph_ms(
            lambda: at.mha_qkv_i8(codes, scales, quant_out=True, **kw))
        b, s, h3 = codes.shape
        nh = kw["n_head"]
        vl, hl = kw["valid_len"] or s, h3 // 3
        res[f"mha_qkv_i8_{name}_bound"] = bound(b * s * h3 + 4 * b * s + 2 * b * s * hl,
                                                int8_ops=2 * b * s * vl * hl,
                                                bf16_flops=2 * b * s * vl * hl)
        deq = (codes.float() * scales[..., None]).to(torch.bfloat16)
        q, k, v = (t.contiguous() for t in deq.reshape(b, s, 3, nh, -1).permute(2, 0, 3, 1, 4))
        res[f"sdpa_i8_{name}_ms"] = sdpa_ms(q, k, v, kw["causal"], kw["scale"], kw["valid_len"])
    codes, scales, kw = a["mha_qkv_i8_vision"]
    res["mha_qkv_i8_vision_plain_ms"] = graph_ms(
        lambda: at.mha_qkv_i8_plain(codes, scales, **kw), iters=10)

    # the cut towers: on pixels already on the card, and their stacks alone
    for name, eng, batches in (("h14", engines["h14_staged_mlp"], (64,)),
                               ("l14_336", engines["l14_336_staged_attn"], (1, 4))):
        cfg = eng.config.vision
        layers = eng.params["vision"]["layers"]
        s_real = (cfg.image_size // cfg.patch_size) ** 2 + 1
        for b in batches:
            px = torch.randn(b, cfg.image_size, cfg.image_size, 3, device="cuda")
            px = px.to(torch.bfloat16)

            def tower(eng=eng, px=px):
                with torch.inference_mode():
                    return encode_image(eng.params["vision"], cfg, px, use_gelu=False,
                                        compute_dtype=torch.bfloat16, **eng.tower_flags())

            sp = pad_once(b, s_real, cfg, True)
            x = torch.randn(b, sp, cfg.hidden_size, device="cuda").to(torch.bfloat16)

            def stack(eng=eng, x=x, sp=sp):
                with torch.inference_mode():
                    return run_blocks(x, layers, n_head=cfg.n_head, eps=cfg.eps, use_gelu=False,
                                      valid_len=s_real if sp != s_real else None,
                                      **eng.tower_flags())

            tower_ms = [cuda_ms(tower, iters=3, warmup=1 if i == 0 else 0) for i in range(3)]
            stack_ms = cuda_ms(stack, iters=3, warmup=1)
            res[f"tower_{name}_b{b}"] = {
                "layers": cfg.n_layer, "seq": sp, "valid_len": s_real,
                "tower_median_ms": statistics.median(tower_ms), "tower_runs_ms": tower_ms,
                "stack_ms": stack_ms, "ms_per_layer": stack_ms / cfg.n_layer}
            if b == batches[-1]:
                res[f"tower_{name}_b{b}_profile"] = profile_kernels(tower)
    return res


def attn_block_stream_bound(b: int, s: int, h: int) -> tuple[float, str]:
    """Row 8 over ``x [b, s, h]``: x read and the output written, both int8
    weights, the vectors; the two GEMMs at the int8 peak and the attention
    products at the bf16 peak."""
    rows = b * s
    return bound(2 * rows * h * 2 + 4 * h * h + 4 * 4 * h + 2 * 4 * 3 * h,
                 int8_ops=2 * rows * 4 * h * h, bf16_flops=4 * b * s * s * h)


def stream_bounds(sck: dict) -> dict:
    """Bounds of the last five kernels at the shapes of their kernels line:
    each input read once, each output written once, int8 products at the
    int8 peak, the attention products at the bf16 peak."""
    a = sck["args"]
    vecs = lambda n: 4 * n  # noqa: E731  (f32 vector bytes)
    out = {}
    (x, *_), kw = a["attn_block_stream_b16_384"]
    out["attn_block_stream"] = attn_block_stream_bound(*x.shape)
    (x, *_), kw = a["mlp_lnq_stream_h14_exact"]
    rows, h = x.shape
    f = 4 * h
    out["mlp_lnq_stream"] = bound(2 * rows * h * 2 + 2 * f * h + 4 * vecs(h) + 2 * vecs(f),
                                  int8_ops=2 * rows * 2 * f * h)
    yq = a["actq"]
    out["actq"] = bound(yq.numel() * 4 + yq.numel() + 4 * yq.shape[0])
    (x, *_), kw = a["layer_block_vision"]
    b, s, h = x.shape
    rows, f = b * s, 4 * h
    out["layer_block"] = bound(
        2 * rows * h * 2 + 4 * h * h + 2 * f * h + 8 * vecs(h) + 2 * vecs(3 * h) + 2 * vecs(f),
        int8_ops=2 * rows * (4 * h * h + 2 * f * h), bf16_flops=4 * b * s * s * h)
    q, _, _, kw = a["mha_vision_bf16"]
    b, s, h = q.shape
    out["mha"] = bound(4 * b * s * h * 2, bf16_flops=4 * b * s * s * h)
    return out


def stream_timing(sck: dict, engines: dict) -> dict:
    """Phase: device times (CUDA-graph replay) of the last five kernels and
    their plain versions at the shapes checked, SDPA on the same q, k, v
    beside ``mha`` (the same function but for the TPU kernel's clipped
    softmax and its bf16 p), and the ViT-B/16-384 tower at B = 1 and 8,
    whole and per layer, with its profile at B = 8."""
    import torch

    from clip_tpu_torch.models.transformer import run_blocks
    from clip_tpu_torch.models.vision import encode_image, pad_once
    from clip_tpu_torch.ops import actquant as aq
    from clip_tpu_torch.ops import attention as at

    a = sck["args"]
    res: dict = {}
    for name in ("b16_384", "h14_408"):
        args, kw = a[f"attn_block_stream_{name}"]
        res[f"attn_block_stream_{name}_ms"] = graph_ms(lambda: at.attn_block_stream(*args, **kw))
    args, kw = a["attn_block_stream_b16_384"]
    res["attn_block_stream_b16_384_plain_ms"] = graph_ms(
        lambda: at.attn_block_stream_plain(*args, **kw), iters=10)
    x8 = torch.randn(8, 584, 768, device="cuda").bfloat16()
    res["attn_block_stream_b16_384_b8_ms"] = graph_ms(
        lambda: at.attn_block_stream(x8, *args[1:], **kw))
    res["attn_block_stream_b16_384_b8_bound"] = attn_block_stream_bound(*x8.shape)
    for name in ("exact", "chunks8"):
        args, kw = a[f"mlp_lnq_stream_h14_{name}"]
        res[f"mlp_lnq_stream_h14_{name}_ms"] = graph_ms(lambda: aq.mlp_lnq_stream(*args, **kw))
    args, kw = a["mlp_lnq_stream_h14_exact"]
    res["mlp_lnq_stream_h14_exact_plain_ms"] = graph_ms(
        lambda: aq.mlp_lnq_stream_plain(*args, **kw), iters=5)
    yq = a["actq"]
    res["actq_ms"] = graph_ms(lambda: aq.actq(yq, "gelu_quick"))
    res["actq_plain_ms"] = graph_ms(lambda: aq.actq_plain(yq, "gelu_quick"), iters=10)
    yq16 = yq.bfloat16()
    res["actq_bf16_ms"] = graph_ms(lambda: aq.actq(yq16, "gelu_quick"))
    for name in ("vision", "text"):
        largs, kw = a[f"layer_block_{name}"]
        res[f"layer_block_{name}_ms"] = graph_ms(lambda: at.layer_block(*largs, **kw))
    largs, kw = a["layer_block_vision"]
    res["layer_block_vision_plain_ms"] = graph_ms(lambda: at.layer_block_plain(*largs, **kw),
                                                  iters=10)
    for key in ("vision_bf16", "vision_f32", "text_bf16", "text_f32"):
        q, k, v, kw = a[f"mha_{key}"]
        b, s, h = q.shape
        nh = kw["n_head"]
        res[f"mha_{key}_ms"] = graph_ms(lambda: at.mha(q, k, v, **kw))
        qh, kh, vh = (t.view(b, s, nh, h // nh).transpose(1, 2) for t in (q, k, v))
        res[f"sdpa_{key}_ms"] = sdpa_ms(qh, kh, vh, kw["causal"], kw["scale"], None)
    q, k, v, kw = a["mha_vision_bf16"]
    res["mha_vision_bf16_plain_ms"] = graph_ms(lambda: at.mha_plain(q, k, v, **kw), iters=10)

    # the attention core alone (f32 out, as row 8 calls it) at ViT-B/16-384
    # [B, 584 valid 577, 12 x 64], against its plain version and SDPA
    for b in (1, 8):
        qkv = torch.randn(b * 584, 3 * 768, device="cuda").bfloat16()
        got = at.attention_heads(qkv, b, 584, 12, 0.125, valid_len=577)
        want = at.attention_heads_plain(qkv, b, 584, 12, 0.125, valid_len=577)
        c = cos(got, want)
        if not c > 0.9999:
            raise AssertionError(f"attention_heads b16_384 B = {b}: cos {c}")
        res[f"attention_heads_b16_384_b{b}_ms"] = graph_ms(
            lambda: at.attention_heads(qkv, b, 584, 12, 0.125, valid_len=577))
        res[f"attention_heads_b16_384_b{b}_bound"] = attention_bound(b, 584, 768, 577, 2, 4)
        res[f"attention_heads_b16_384_b{b}_cos"] = c
        q, k, v = qkv.reshape(b, 584, 3, 12, 64).permute(2, 0, 3, 1, 4)
        res[f"sdpa_b16_384_b{b}_ms"] = sdpa_ms(q, k, v, False, 0.125, 577)

    eng = engines["b16_384_stream_attn"]
    cfg = eng.config.vision
    layers = eng.params["vision"]["layers"]
    s_real = (cfg.image_size // cfg.patch_size) ** 2 + 1
    for b in (1, 8):
        px = torch.randn(b, cfg.image_size, cfg.image_size, 3, device="cuda").bfloat16()

        def tower(px=px):
            with torch.inference_mode():
                return encode_image(eng.params["vision"], cfg, px, use_gelu=False,
                                    compute_dtype=torch.bfloat16, **eng.tower_flags())

        sp = pad_once(b, s_real, cfg, True)
        x = torch.randn(b, sp, cfg.hidden_size, device="cuda").bfloat16()

        def stack(x=x):
            with torch.inference_mode():
                return run_blocks(x, layers, n_head=cfg.n_head, eps=cfg.eps, use_gelu=False,
                                  valid_len=s_real, **eng.tower_flags())

        tower_ms = [cuda_ms(tower, iters=3, warmup=1 if i == 0 else 0) for i in range(3)]
        stack_ms = cuda_ms(stack, iters=3, warmup=1)
        res[f"tower_b16_384_b{b}"] = {
            "layers": cfg.n_layer, "seq": sp, "valid_len": s_real,
            "tower_median_ms": statistics.median(tower_ms), "tower_runs_ms": tower_ms,
            "stack_ms": stack_ms, "ms_per_layer": stack_ms / cfg.n_layer}
        if b == 8:
            res["tower_b16_384_b8_profile"] = profile_kernels(tower)
    return res


def route_difference(eng) -> dict:
    """Phase: what the route change does at ViT-L/14-336 on the card, one
    layer of the L/14-336 engine at B = 1 and 4.  The reference is the
    JAX package's route in plain float32 (the padded S = 584, valid 577,
    staged attention, and at B = 1 the o projection on the q4_0 source);
    beside it the port's staged route in bf16 with its kernels, and the
    route the port took before it copied the route gates: the fused
    attention block at S = 577.  cos and max error on the 577 real rows, and
    the cos of what the layer adds to its input (output - x), which the
    residual does not dominate."""
    import torch

    from clip_tpu_torch.models.transformer import block, layer
    from clip_tpu_torch.ops import actquant as aq
    from clip_tpu_torch.ops import attention as at

    cfg = eng.config.vision
    lp = layer(eng.params["vision"]["layers"], 0)
    q8, o8, up, dn = (lp[k] for k in ("qkv_w", "o_w", "up_w", "down_w"))
    rng = np.random.default_rng(7)
    out = {}
    for b in (1, 4):
        x = rng.normal(0, 1, (b, 584, cfg.hidden_size)).astype(np.float32)
        x[:, 577:] = 0.0
        x = torch.from_numpy(x).cuda()
        kw = dict(n_head=cfg.n_head, eps=cfg.eps, use_gelu=False)
        ref = block(x, lp, kernels=False, valid_len=577, **kw)[:, :577]
        new = block(x.bfloat16(), lp, valid_len=577, **kw)[:, :577].float()
        x577 = x[:, :577].bfloat16().contiguous()
        old = at.attn_block(x577, lp["ln1_w"], lp["ln1_b"], q8.c8, q8.ws, lp["qkv_b"], o8.c8,
                            o8.ws, lp["o_b"], n_head=cfg.n_head,
                            scale=(cfg.hidden_size // cfg.n_head) ** -0.5, eps=cfg.eps)
        old = aq.mlp_lnq(old.reshape(b * 577, -1), lp["ln2_w"], lp["ln2_b"], up.c8, up.ws,
                         lp["up_b"], dn.c8, dn.ws, lp["down_b"], eps=cfg.eps)
        old = old.reshape(b, 577, -1).float()
        torch.cuda.synchronize()
        x0 = x[:, :577]
        out[f"b{b}"] = {f"{n}_vs_ref": dict(cos=cos(v, ref), layer_delta_cos=cos(v - x0, ref - x0),
                                            max_abs_err=float((v - ref).abs().max()))
                        for n, v in (("staged_kernels", new), ("fused_s577_kernels", old))}
    return out


def timing(device, chk: dict, engines: dict) -> dict:
    """Phase 6: device times of each kernel and its plain version at the
    main paths' shapes, and each engine's vision encode rate at B = 256."""
    import torch

    from clip_tpu_torch.models.vision import encode_image
    from clip_tpu_torch.ops import actquant as aq
    from clip_tpu_torch.ops import attention as at
    from clip_tpu_torch.ops import qmatmul as qmm

    res: dict = {}
    steps: dict = {}  # wall seconds of the phase's steps
    t0 = time.perf_counter()
    for tower in ("vision", "text"):
        c = chk[tower]
        res[tower] = {
            "attn_block_ms": graph_ms(lambda: at.attn_block(*c["ab_args"], **c["ab_kw"])),
            "attn_block_plain_ms": graph_ms(
                lambda: at.attn_block_plain(*c["ab_args"], **c["ab_kw"]), iters=10),
            "mlp_lnq_ms": graph_ms(lambda: aq.mlp_lnq(*c["mlp_args"], eps=1e-5)),
            "mlp_lnq_plain_ms": graph_ms(lambda: aq.mlp_lnq_plain(*c["mlp_args"], eps=1e-5),
                                         iters=10),
            # eager back-to-back calls: what the wrappers cost with their
            # Python and launch overhead
            "attn_block_eager_ms": cuda_ms(lambda: at.attn_block(*c["ab_args"], **c["ab_kw"])),
            "mlp_lnq_eager_ms": cuda_ms(lambda: aq.mlp_lnq(*c["mlp_args"], eps=1e-5)),
        }
        # the chain's parts, to see where a block's time goes
        x2, lnw, lnb, qw8, qws, qb, ow8, ows, ob = c["ab_args"]
        b, s, h, nh, f = c["shape"]
        x2 = x2.reshape(b * s, h)
        codes, sx = aq.lnq(x2, lnw, lnb, 1e-5)
        qkv = aq.gemm_i8(codes, qw8, sx, qws, qb, aq.BIAS)
        att = at.attention_heads(qkv, b, s, nh, c["ab_kw"]["scale"], c["causal"])
        c2, s2 = aq.requant(att)
        _, _, _, up8, upws, upb, dn8, dnws, dnb = c["mlp_args"]
        y = aq.gemm_i8(codes, up8, sx, upws, upb, aq.GELU_QUICK)
        c3, s3 = aq.requant(y)
        res[tower]["parts_ms"] = {
            "lnq": graph_ms(lambda: aq.lnq(x2, lnw, lnb, 1e-5)),
            "gemm_qkv": graph_ms(lambda: aq.gemm_i8(codes, qw8, sx, qws, qb, aq.BIAS)),
            "attention": graph_ms(lambda: at.attention_heads(
                qkv, b, s, nh, c["ab_kw"]["scale"], c["causal"])),
            "requant_attn": graph_ms(lambda: aq.requant(att)),
            "gemm_o_resid": graph_ms(lambda: aq.gemm_i8(c2, ow8, s2, ows, ob, aq.RESID,
                                                        resid=x2)),
            "gemm_up_gelu": graph_ms(lambda: aq.gemm_i8(codes, up8, sx, upws, upb,
                                                        aq.GELU_QUICK)),
            "requant_up": graph_ms(lambda: aq.requant(y)),
            "gemm_gq_up": graph_ms(lambda: aq.gemm_gq(codes, sx, up8, upws, upb)),
            "gemm_down_resid": graph_ms(lambda: aq.gemm_i8(c3, dn8, s3, dnws, dnb, aq.RESID,
                                                           resid=x2)),
        }
        # yardsticks: one PyTorch call for a part of the chain (the port never calls these)
        yard = {}
        try:
            yard["torch._int_mm_qkv_ms"] = graph_ms(lambda: torch._int_mm(codes, qw8.t()))
        except RuntimeError as e:  # not every build has the int8 GEMM for this shape
            yard["torch._int_mm_qkv_ms"] = f"not measured: {str(e).splitlines()[0]}"
        q, k, v = qkv.reshape(b, s, 3, nh, h // nh).permute(2, 0, 3, 1, 4)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        yard["sdpa_ms"] = sdpa_ms(q, k, v, c["causal"], c["ab_kw"]["scale"], None)
        res[tower]["yardsticks"] = yard
    steps["blocks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # attention with the bf16 output: the kernel, its plain version, and one
    # scaled_dot_product_attention call on the same q, k, v views with the
    # same mask (the library column only; the port never calls it)
    for name, (qkv, kw) in chk["mha_args"].items():
        res[f"mha_qkv_{name}_ms"] = graph_ms(lambda: at.mha_qkv(qkv, **kw))
        b, s, h3 = qkv.shape
        res[f"mha_qkv_{name}_bound"] = attention_bound(b, s, h3 // 3, kw["valid_len"], 2, 2)
        q, k, v = qkv.reshape(b, s, 3, kw["n_head"], -1).permute(2, 0, 3, 1, 4)
        if name in ("vision", "text"):
            res[f"mha_qkv_{name}_plain_ms"] = graph_ms(lambda: at.mha_qkv_plain(qkv, **kw),
                                                       iters=10)
        res[f"sdpa_{name}_ms"] = sdpa_ms(q, k, v, kw["causal"], kw["scale"], kw["valid_len"])
    for fmt, (xq, wq) in chk["qmatmul_args"].items():
        fn = getattr(qmm, f"qmatmul_q{fmt[1]}")
        res[f"qmatmul_{fmt}_ms"] = graph_ms(lambda: fn(xq, wq))
        res[f"qmatmul_{fmt}_plain_ms"] = graph_ms(lambda: qmm.qmatmul_plain(xq, wq))
    xq, wq = chk["qmatmul_args"]["q4_0"]
    res["qmatmul_q4_0_eager_ms"] = cuda_ms(lambda: qmm.qmatmul_q4(xq, wq))
    steps["mha_qkv_qmatmul"] = time.perf_counter() - t0

    # vision encode at B = 256 for each engine: the engine call from host
    # float pixels (includes the host->device copy and the readback), and
    # the tower alone on pixels already on the card
    t0 = time.perf_counter()
    pixels = np.random.default_rng(2).standard_normal((256, 224, 224, 3), dtype=np.float32)
    px = torch.from_numpy(pixels).to(device).to(torch.bfloat16)
    steps["pixels"] = time.perf_counter() - t0
    for name, eng in engines.items():
        t0 = time.perf_counter()
        eng.encode_image(pixels)
        host_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.encode_image(pixels)
            host_s.append(time.perf_counter() - t0)

        def tower(eng=eng):
            with torch.inference_mode():
                return encode_image(eng.params["vision"], eng.config.vision, px,
                                    use_gelu=eng.config.use_gelu, compute_dtype=torch.bfloat16)

        dev_ms = [cuda_ms(tower, iters=1, warmup=1 if i == 0 else 0) for i in range(5)]
        steps[f"b256_{name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res[f"vision_b256_{name}_profile"] = profile_kernels(tower)
        steps[f"profile_{name}"] = time.perf_counter() - t0
        res[f"vision_b256_{name}"] = {
            "engine_median_s": statistics.median(host_s), "engine_runs_s": host_s,
            "engine_images_per_s": 256 / statistics.median(host_s),
            "tower_median_ms": statistics.median(dev_ms), "tower_runs_ms": dev_ms,
            "tower_images_per_s": 256 / (statistics.median(dev_ms) / 1e3),
        }
    res["steps_s"] = steps
    return res


# gemm_gq phases (csrc/gemm_gq.cu GQ_PHASE): the spans between timestamps
GQ_PHASES = ("first_stage", "mainloop", "act", "row_maxima", "cluster_meet", "scales", "codes",
             "cluster_exit")
# name -> (rows, N, K, requant group): ViT-H/14's up GEMM (the full row and
# 8 chunks) and ViT-B/32's at B = 256 and 64
GQ_PHASE_SHAPES = {"h14": (16896, 5120, 1280, 5120), "h14_chunks8": (16896, 5120, 1280, 640),
                   "b32_b256": (12800, 3072, 768, 3072), "b32_b64": (3200, 3072, 768, 3072)}


def gemm_gq_phases() -> dict:
    """Where a ``ctt_gemm_gq`` block's time goes: ``gemm_gq.cu`` built once
    more with ``-DCTT_GQ_PHASES`` (a %globaltimer stamp per phase and block),
    run at ``GQ_PHASE_SHAPES`` with gelu_quick; the mean microseconds of each
    phase, a block's lifetime, how many blocks were alive on average, and
    the kernel's span."""
    import ctypes

    import torch

    from clip_tpu_torch.ops import _cuda
    from clip_tpu_torch.ops import actquant as aq

    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libgq_phases.so")
        subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-Xcompiler", "-fPIC", "-shared", "-DCTT_GQ_PHASES", "-o", so,
                        str(_cuda.SRC_DIR / "gemm_gq.cu")],
                       capture_output=True, text=True, timeout=600, check=True)
        lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ctt_gemm_gq.argtypes = [p, p, i, i, i, p, p, p, p, p, i, i, i, i, p]
    lib.ctt_gemm_gq_phases_to.argtypes = [p]
    rng = np.random.default_rng(14)
    out = {}
    for name, (m, n, k, group) in GQ_PHASE_SHAPES.items():
        cs, cpb = aq.gq_plan(group)
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
        b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).cuda()
        sx = torch.from_numpy(rng.uniform(0.001, 0.01, m).astype(np.float32)).cuda()
        ws = torch.from_numpy(rng.uniform(0.001, 0.01, n).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(0, 0.05, n).astype(np.float32)).cuda()
        codes = torch.empty(m, n, dtype=torch.int8, device="cuda")
        scales = torch.empty(m, n // group, device="cuda")
        blocks = (n // group) * cs * -(-m // aq.GQ_ROWS)
        stamps = torch.zeros(blocks * 9, dtype=torch.int64, device="cuda")
        _cuda.check(lib.ctt_gemm_gq_phases_to(stamps.data_ptr()), "ctt_gemm_gq_phases_to")
        for _ in range(3):  # the last run's stamps stay
            _cuda.check(lib.ctt_gemm_gq(a.data_ptr(), b.data_ptr(), m, n, k, sx.data_ptr(),
                                        ws.data_ptr(), bias.data_ptr(), codes.data_ptr(),
                                        scales.data_ptr(), aq.GELU_QUICK, group, cs, cpb,
                                        _cuda.stream(a)), "ctt_gemm_gq")
        torch.cuda.synchronize()
        t = stamps.view(blocks, 9).cpu().numpy().astype(np.float64) / 1e3
        life = t[:, 8] - t[:, 0]
        span = t[:, 8].max() - t[:, 0].min()
        out[name] = dict(cluster=cs, columns=cpb, blocks=blocks, span_us=float(span),
                         block_life_us=float(life.mean()),
                         blocks_alive=float(life.sum() / span),
                         phase_us={ph: float(d) for ph, d in zip(GQ_PHASES,
                                                                 np.diff(t, axis=1).mean(0))})
    return out


def gemm_only() -> int:
    """``--gemm-yardsticks``: build the kernels of the ``clip_tpu_torch`` next
    to this script and print :func:`gemm_yardsticks` as one JSON line (how
    two versions of the GEMM are compared in one call: a copy of this script
    beside each package)."""
    from clip_tpu_torch.ops import _cuda

    _cuda.lib()
    say(json.dumps({"card": nvidia_smi(), "gemm_yardsticks": gemm_yardsticks()}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] == ["--gemm-yardsticks"]:
        return gemm_only()
    if sys.argv[1:] == ["--gemm-gq-phases"]:
        say(json.dumps({"card": nvidia_smi(), "gemm_gq_phases": gemm_gq_phases()}))
        return 0
    from clip_tpu_torch.ops import _cuda
    from clip_tpu_torch.ops import actquant as aq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase_line("device", t0, kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
               torch=torch.__version__, cuda=torch.version.cuda,
               startup_s=round(t0 - T_START, 2))

    # the checkpoints are written by worker processes while nvcc builds
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            max_workers=len(PATHS) + len(CUT_PATHS),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        ckpts = write_checkpoints(pool, tmp)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=1) as builder:
            build = builder.submit(_cuda.build, force=True)
            # the profiler's first trace sets up its device tracing, which
            # takes seconds: pay that while nvcc runs
            profile_kernels(lambda: torch.ones(1, device=device) + 1)
            info = build.result()
        _cuda.lib()
        say("[ptxas]\n" + info.ptxas)
        phase_line("build", t0, nvcc_seconds=round(info.seconds, 2), nvcc_calls=info.nvcc_calls,
                   tensor_core_instructions=tensor_core_counts(),
                   gemm_launch_info=gemm_launch_info())

        t0 = time.perf_counter()
        chk = check_kernels(device)
        summary = {t: {k: v for k, v in chk[t].items() if k.endswith(("cos", "err", "mismatch"))}
                   for t in ("vision", "text")}
        summary.update({k: v for k, v in chk.items() if k.endswith("_err")})
        phase_line("kernels", t0, **summary)

        t0 = time.perf_counter()
        schk = check_staged_kernels(device)
        phase_line("staged_kernels", t0, **{k: v for k, v in schk.items() if k != "args"})

        t0 = time.perf_counter()
        sck = check_stream_kernels(device)
        phase_line("stream_kernels", t0, **{k: v for k, v in sck.items() if k != "args"})

        paths: dict = {}
        for name, (ckpt, engine_kw, drives) in PATH_RUNS.items():
            t0 = time.perf_counter()
            path = ckpts[ckpt].result()
            wait_s = time.perf_counter() - t0
            p = paths[name] = run_path(name, path, engine_kw, drives)
            phase_line(f"path_{name}", t0, route=p["route"], flags=p["engine"].tower_flags(),
                       launches=p["launches"], expected=p["expect"],
                       checkpoint_wait_s=round(wait_s, 2), load_s=round(p["load_s"], 2),
                       run_s={k: round(v, 2) for k, v in p["run_s"].items()},
                       plain_s=round(p["plain_s"], 2),
                       **{k: v for k, v in p.items()
                          if k.endswith(("cos", "zsl", "plain", "max_diff"))})
    # the q4_0 main path's block chains launch ctt_gemm_i8 for qkv and o in
    # each attention block and for the down GEMM of each MLP block
    main = paths["q4_0"]["launches"]["main"]
    n_i8 = paths["q4_0"]["gemm_i8_launches"]["main"]
    assert n_i8 == 2 * main["attn_block"] + main["mlp_lnq"] > 0, f"q4_0: gemm_i8 launches {n_i8}"
    engines = {n: p.pop("engine") for n, p in paths.items()}
    for name in ("q5_1", "q8_0", "b32_up_gq"):
        del engines[name]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ms = mlp_stream_path(engines["h14_staged_mlp"])
    phase_line("h14_mlp_stream", t0, **ms)

    t0 = time.perf_counter()
    ls = long_sequence(engines["l14_336_staged_attn"])
    phase_line("long_sequence", t0, **ls)

    t0 = time.perf_counter()
    i8 = attn_i8_stacks(engines)
    phase_line("attn_i8_stacks", t0, **i8)

    t0 = time.perf_counter()
    phase_line("route_difference", t0, **route_difference(engines["l14_336_staged_attn"]))

    t0 = time.perf_counter()
    tm = timing(device, chk, {n: engines[n] for n in ("q4_0", "f16")})
    phase_line("timing", t0, card=smi, **tm)

    t0 = time.perf_counter()
    st = staged_timing(schk, engines)
    phase_line("staged_timing", t0, card=smi, **st)

    t0 = time.perf_counter()
    sst = stream_timing(sck, engines)
    phase_line("stream_timing", t0, card=smi, **sst)

    t0 = time.perf_counter()
    gy = gemm_yardsticks()
    q = GEMM_SHAPES["b32_b256_qkv"]
    a = torch.from_numpy(np.random.default_rng(12).integers(-127, 128, q[::2], dtype=np.int8))
    b = torch.from_numpy(np.random.default_rng(13).integers(-127, 128, q[1:], dtype=np.int8))
    a, b = a.cuda(), b.cuda()
    gy["b32_b256_qkv"]["plain_ms"] = graph_ms(
        lambda: aq.gemm_i8_plain(a, b, None, None, None, aq.ACC), iters=5)
    gy["b32_b256_qkv"]["max_abs_err"] = float(
        (aq.gemm_i8(a, b, None, None, None, aq.ACC)
         - aq.gemm_i8_plain(a, b, None, None, None, aq.ACC)).abs().max())
    phase_line("gemm_yardsticks", t0, card=smi, **gy)

    bounds = {**kernel_bounds(chk), **staged_bounds(schk), **stream_bounds(sck)}
    bounds["gemm_i8"] = (gy["b32_b256_qkv"]["bound_ms"], gy["b32_b256_qkv"]["bound_by"])
    v = tm["vision"]

    def row(name, source, replaces, launches, ms, plain_ms, err, bound_key, library_ms=None):
        ms_bound, by = bounds[bound_key]
        lib = library_ms if isinstance(library_ms, float) else None
        return dict(name=name, route="cuda", source=f"clip_tpu_torch/csrc/{source}",
                    replaces=f"clip_tpu/ops/{replaces}", launches=launches,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=ms_bound, bound_by=by,
                    library_ms=lib)

    def main_launches(path, name):
        return paths[path]["launches"]["main"][name]

    def run_launches(name):
        """Launches of ``name`` summed over every path run of the smoke."""
        counts = [d for p in paths.values() for d in p["launches"].values()]
        counts += [ms["launches"], ls["launches"]] + [r["launches"] for r in i8.values()]
        return sum(d[name] for d in counts)

    kernels = [
        row("attn_block", "attention.cu", "attention_pallas.py:484",
            main_launches("q4_0", "attn_block"), v["attn_block_ms"], v["attn_block_plain_ms"],
            chk["vision"]["attn_block_err"], "attn_block"),
        row("mlp_lnq", "actquant.cu", "actquant_pallas.py:362", main_launches("q4_0", "mlp_lnq"),
            v["mlp_lnq_ms"], v["mlp_lnq_plain_ms"], chk["vision"]["mlp_lnq_err"], "mlp_lnq"),
        row("qmatmul_q4", "qmatmul.cu", "qmatmul_pallas.py:69",
            main_launches("q4_0", "qmatmul_q4"), tm["qmatmul_q4_0_ms"],
            tm["qmatmul_q4_0_plain_ms"], chk["qmatmul_q4_0_m64_err"], "qmatmul_q4_0"),
        row("qmatmul_q5", "qmatmul.cu", "qmatmul_pallas.py:103",
            main_launches("q5_1", "qmatmul_q5"), tm["qmatmul_q5_1_ms"],
            tm["qmatmul_q5_1_plain_ms"], max(chk["qmatmul_q5_1_m64_err"],
                                             chk["qmatmul_q5_0_m64_err"]), "qmatmul_q5_1"),
        row("qmatmul_q8", "qmatmul.cu", "qmatmul_pallas.py:151",
            main_launches("q8_0", "qmatmul_q8"), tm["qmatmul_q8_0_ms"],
            tm["qmatmul_q8_0_plain_ms"], chk["qmatmul_q8_0_m64_err"], "qmatmul_q8_0"),
        row("mha_qkv", "attention.cu", "attention_pallas.py:1014",
            main_launches("f16", "mha_qkv"), tm["mha_qkv_vision_ms"],
            tm["mha_qkv_vision_plain_ms"], chk["mha_qkv_vision_err"], "mha_qkv_vision",
            tm["sdpa_vision_ms"]),
        row("lnq", "actquant.cu", "actquant_pallas.py:71",
            main_launches("h14_staged_mlp", "lnq"), st["lnq_h14_ms"], st["lnq_h14_plain_ms"],
            schk["lnq_h14_err"], "lnq"),
        # 6a: the int8 GEMM alone (ACC) at ViT-B/32's qkv at B = 256; its
        # launches are the q4_0 main path's (qkv, o and down GEMMs)
        row("gemm_i8", "actquant.cu", "actquant_pallas.py:172", n_i8,
            gy["b32_b256_qkv"]["ms"], gy["b32_b256_qkv"]["plain_ms"],
            gy["b32_b256_qkv"]["max_abs_err"], "gemm_i8", gy["b32_b256_qkv"]["int_mm_ms"]),
        row("gemm_gq", "gemm_gq.cu", "actquant_pallas.py:172",
            main_launches("h14_staged_mlp", "gemm_gq"), st["gemm_gq_h14_ms"],
            st["gemm_gq_h14_plain_ms"], schk["gemm_gq_h14_err"], "gemm_gq"),
        row("mlp_gq", "actquant.cu", "actquant_pallas.py:296",
            main_launches("b32_up_gq", "mlp_gq"), st["mlp_gq_b32_ms"], st["mlp_gq_b32_plain_ms"],
            schk["mlp_gq_b32_err"], "mlp_gq"),
        row("mha_qkv_i8", "attention.cu", "attention_pallas.py:278",
            sum(r["launches"]["mha_qkv_i8"] for r in i8.values()), st["mha_qkv_i8_vision_ms"],
            st["mha_qkv_i8_vision_plain_ms"], schk["mha_qkv_i8_vision_err"], "mha_qkv_i8",
            st["sdpa_i8_vision_ms"]),
        # rows 8-13: launches over every path run; no route reaches actq,
        # layer_block or mha, and every path asserts their count (0)
        row("attn_block_stream", "actquant.cu", "attention_pallas.py:648",
            run_launches("attn_block_stream"),
            sst["attn_block_stream_b16_384_ms"], sst["attn_block_stream_b16_384_plain_ms"],
            sck["attn_block_stream_b16_384_err"], "attn_block_stream"),
        row("mlp_lnq_stream", "actquant.cu", "actquant_pallas.py:483",
            ms["launches"]["mlp_lnq_stream"], sst["mlp_lnq_stream_h14_exact_ms"],
            sst["mlp_lnq_stream_h14_exact_plain_ms"], sck["mlp_lnq_stream_h14_exact_err"],
            "mlp_lnq_stream"),
        row("actq", "actquant.cu", "actquant_pallas.py:119", run_launches("actq"),
            sst["actq_ms"], sst["actq_plain_ms"], sck["actq_gelu_quick_err"], "actq"),
        row("layer_block", "attention.cu", "attention_pallas.py:877", run_launches("layer_block"),
            sst["layer_block_vision_ms"], sst["layer_block_vision_plain_ms"],
            sck["layer_block_vision_err"], "layer_block"),
        row("mha", "attention.cu", "attention_pallas.py:1119", run_launches("mha"),
            sst["mha_vision_bf16_ms"], sst["mha_vision_bf16_plain_ms"],
            sck["mha_vision_bf16_err"], "mha",
            sst["sdpa_vision_bf16_ms"]),
    ]
    say(f"[total] {time.perf_counter() - T_START:.2f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
