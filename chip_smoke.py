#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``clip_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one flushed line with its wall seconds:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the kernels of ``clip_tpu_torch/csrc`` in one ``nvcc`` call, with
   the ``-Xptxas -v`` register and spill summary.  Meanwhile a pool of
   worker processes writes the seeded random checkpoints of the path
   phases into a temporary directory, and the profiler sets up its device
   tracing;
3. kernels: every kernel wrapper against its plain PyTorch version on the
   card, at the main paths' shapes (ViT-B/32: vision rows 64 x 50, text rows
   8 x 80 causal, projection M = 64 and M = 1 with q4_0/q4_1/q5_0/q5_1/q8_0
   [512, 768] weights), and ``mha_qkv`` / ``attention_heads`` at the long
   sequences of other catalog models (ViT-H/14's d_head 80 at S = 257,
   ViT-L/14-336's S = 577 and its pad-once S = 584);
4. paths: ``ClipEngine`` on CUDA over four ViT-B/32 checkpoints, each run
   with every launch counter set to 0 just before it and read just after:
   q4_0 two towers (the W8A8 main path) and f16 two towers (the dense path),
   each 64 images + 8 prompts + one zero-shot labeling; q5_1 and q8_0 vision
   towers, 64 images each.  Every counter must rise by the count the path
   implies, the embeddings must be finite and unit-norm and agree (per-row
   cos > 0.999) with the same engine forced onto its plain versions in
   float32;
5. long_sequence: a two-layer W8A8 stack at ViT-L/14-336's widths (H 1024,
   16 heads, MLP 4096, S 577) through ``run_blocks``, kernels against the
   plain versions (cos > 0.999);
6. timing (reported, not gated): each kernel, its plain version, one
   PyTorch library call where one computes the same function, and the
   q4_0 and f16 vision towers at B = 256.

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


def graph_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` in ms: ``fn`` is captured once in a CUDA
    graph and the graph replayed ``iters`` times between two CUDA events, so
    the Python and launch overhead of the wrappers is left out."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def bound(nbytes: float, int8_ops: float = 0.0, bf16_flops: float = 0.0) -> tuple[float, str]:
    """Least time in ms for the card: the larger of the compulsory bytes over
    the memory rate and the operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + bf16_flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


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
# wrappers whose launches each path run reads
PATH_WRAPPERS = ("attn_block", "mlp_lnq", "mha_qkv", "qmatmul_q4", "qmatmul_q5", "qmatmul_q8")


def write_checkpoints(pool, tmp: str) -> dict:
    """Submit the path phases' checkpoints to ``pool``; returns futures of
    their paths."""
    from clip_tpu_torch.synth import make_synthetic_gguf

    return {name: pool.submit(make_synthetic_gguf, os.path.join(tmp, f"vit-b-32_{name}.gguf"),
                              "ViT-B/32", ftype=ft, towers=towers, seed=0)
            for name, (ft, towers) in PATHS.items()}


def expected_launches(eng, calls: dict) -> dict:
    """Launches a run of ``calls[tower]`` tower calls implies: the W8A8 route
    runs one attention block and one MLP block per layer, the dense route
    one ``mha_qkv``; each call's block-quantized projection runs the kernel
    of its format (64 rows or fewer: the fused route)."""
    from clip_tpu_torch.ops.qtensor import QTensor

    cfg = {"vision": eng.config.vision, "text": eng.config.text}
    layers = sum(cfg[t].n_layer * n for t, n in calls.items() if n)
    exp = dict.fromkeys(PATH_WRAPPERS, 0)
    if eng.route == "w8a8":
        exp["attn_block"] = exp["mlp_lnq"] = layers
    else:
        exp["mha_qkv"] = layers
    for tower, n in calls.items():
        proj = eng.params[tower]["proj"] if n else None
        if isinstance(proj, QTensor):
            bits = 4 if proj.is_packed4 else 5 if proj.is_packed5 else 8
            exp[f"qmatmul_q{bits}"] += n
    return exp


def run_path(name: str, path: str) -> dict:
    """One path phase: the engine end to end on ``path`` with the launch
    counters set to 0 just before and read just after, then against the
    plain route in float32."""
    import torch

    from clip_tpu_torch import ops
    from clip_tpu_torch.engine import ClipEngine

    t0 = time.perf_counter()
    eng = ClipEngine(path, verbosity=0)
    assert eng.device.type == "cuda" and eng.compute_dtype == torch.bfloat16
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    images = [(rng.random((256, 320, 3)) * 255).astype(np.uint8) for _ in range(64)]
    prompts = ["a photo of a cat", "a photo of a dog", "a red apple", "the white cat",
               "an apple", "a dog", "a photo of the red dog", "white"]
    labels = ["cat", "dog", "apple"]
    has_text = eng.config.has_text

    def drive(e):
        out = {"image": e.encode_image(images)}
        if has_text:
            out["text"] = e.encode_text(prompts)
            out["zsl"] = e.zero_shot_label_image(images[0], labels)
        return out

    ops.reset_launches()
    t1 = time.perf_counter()
    got = drive(eng)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = {k: v for k, v in ops.launches().items() if k in PATH_WRAPPERS}

    # image 64 (one vision call); text 8 and the zero-shot labeling (image 1
    # + text of 3 labels) add a vision call and two text calls
    expect = expected_launches(eng, {"vision": 2 if has_text else 1,
                                     "text": 2 if has_text else 0})
    assert launches == expect, f"{name}: launches {launches}, expected {expect}"
    for tower in ("image", "text"):
        if tower in got:
            emb = got[tower]
            assert np.isfinite(emb).all(), f"{name}: {tower} embeddings not finite"
            norms = np.linalg.norm(emb, axis=1)
            assert np.abs(norms - 1).max() < 1e-2, f"{name}: {tower} norms {norms}"

    t2 = time.perf_counter()
    ref = ClipEngine(path, compute_dtype="float32", kernels=False, verbosity=0)
    want = drive(ref)
    res = dict(engine=eng, route=eng.route, launches=launches, expect=expect,
               load_s=load_s, run_s=run_s, plain_s=time.perf_counter() - t2)
    for tower in ("image", "text"):
        if tower in got:
            c = float((got[tower] * want[tower]).sum(1).min())
            assert c > 0.999, f"{name}: {tower} embeddings vs plain f32: min cos {c}"
            res[f"{tower}_min_cos"] = c
    if has_text:
        res["zsl"] = [got["zsl"][1].tolist(), got["zsl"][0].tolist()]
        res["zsl_plain"] = [want["zsl"][1].tolist(), want["zsl"][0].tolist()]
    del ref
    torch.cuda.empty_cache()
    return res


def long_sequence(device) -> dict:
    """Phase 5: two W8A8 layers at ViT-L/14-336's widths and S = 577
    through ``run_blocks``, kernels against the plain versions."""
    import torch

    from clip_tpu_torch import ops
    from clip_tpu_torch.gguf.constants import GGMLType
    from clip_tpu_torch.models.transformer import run_blocks
    from clip_tpu_torch.ops.qtensor import W8Tensor

    b, s, h, nh, f, n_layer = 2, 577, 1024, 16, 4096, 2
    rng = np.random.default_rng(3)
    per = [block_weights(rng, h, f, device) for _ in range(n_layer)]
    st = lambda k: torch.stack([p[k] for p in per])  # noqa: E731
    w8 = lambda c, ws: W8Tensor(c8=st(c), ws=st(ws), qtype=GGMLType.F16)  # noqa: E731
    layers = {"ln1_w": st("lnw"), "ln1_b": st("lnb"), "qkv_w": w8("qw8", "qws"),
              "qkv_b": st("qb"), "o_w": w8("ow8", "ows"), "o_b": st("ob"),
              "ln2_w": st("lnw"), "ln2_b": st("lnb"), "up_w": w8("up8", "upws"),
              "up_b": st("upb"), "down_w": w8("dn8", "dnws"), "down_b": st("dnb")}
    x = torch.from_numpy(rng.normal(0, 1, (b, s, h)).astype(np.float32)).to(device)
    x = x.to(torch.bfloat16)
    kw = dict(n_head=nh, eps=1e-5, use_gelu=False)
    ops.reset_launches()
    got = run_blocks(x, layers, **kw)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launches().items() if v}
    want = run_blocks(x, layers, kernels=False, **kw)
    c = cos(got, want)
    assert bool(torch.isfinite(got).all()) and c > 0.999, f"L/14-336 stack: cos {c}"
    assert launches.get("attn_block") == n_layer, launches
    return dict(shape=(b, s, h, nh, f), layers=n_layer, cos=c, launches=launches,
                max_abs_err=float((got.float() - want.float()).abs().max()))


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


def timing(device, chk: dict, engines: dict) -> dict:
    """Phase 6: device times of each kernel and its plain version at the
    main paths' shapes, and each engine's vision encode rate at B = 256."""
    import torch
    import torch.nn.functional as F

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
        yard["sdpa_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=c["causal"]))
        res[tower]["yardsticks"] = yard
    steps["blocks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # attention with the bf16 output: the kernel, its plain version, and one
    # scaled_dot_product_attention call on the same q, k, v views with the
    # same mask (the library column only; the port never calls it)
    for name, (qkv, kw) in chk["mha_args"].items():
        res[f"mha_qkv_{name}_ms"] = graph_ms(lambda: at.mha_qkv(qkv, **kw))
    for name in ("vision", "text"):
        qkv, kw = chk["mha_args"][name]
        b, s, h3 = qkv.shape
        q, k, v = qkv.reshape(b, s, 3, kw["n_head"], -1).permute(2, 0, 3, 1, 4)
        res[f"mha_qkv_{name}_plain_ms"] = graph_ms(lambda: at.mha_qkv_plain(qkv, **kw),
                                                   iters=10)
        try:
            res[f"sdpa_{name}_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=kw["causal"], scale=kw["scale"]))
        except RuntimeError as e:
            res[f"sdpa_{name}_ms"] = f"not measured: {str(e).splitlines()[0]}"
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from clip_tpu_torch.ops import _cuda

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
            max_workers=len(PATHS), mp_context=multiprocessing.get_context("spawn")) as pool:
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
        phase_line("build", t0, nvcc_seconds=round(info.seconds, 2), nvcc_calls=1)

        t0 = time.perf_counter()
        chk = check_kernels(device)
        summary = {t: {k: v for k, v in chk[t].items() if k.endswith(("cos", "err", "mismatch"))}
                   for t in ("vision", "text")}
        summary.update({k: v for k, v in chk.items() if k.endswith("_err")})
        phase_line("kernels", t0, **summary)

        paths: dict = {}
        for name in PATHS:
            t0 = time.perf_counter()
            path = ckpts[name].result()
            wait_s = time.perf_counter() - t0
            p = paths[name] = run_path(name, path)
            phase_line(f"path_{name}", t0, route=p["route"], launches=p["launches"],
                       expected=p["expect"], checkpoint_wait_s=round(wait_s, 2),
                       load_s=round(p["load_s"], 2), run_s=round(p["run_s"], 2),
                       plain_s=round(p["plain_s"], 2),
                       **{k: v for k, v in p.items() if k.endswith(("cos", "zsl", "plain"))})
            if name not in ("q4_0", "f16"):
                del p["engine"]

    t0 = time.perf_counter()
    ls = long_sequence(device)
    phase_line("long_sequence", t0, **ls)

    t0 = time.perf_counter()
    tm = timing(device, chk, {n: paths[n]["engine"] for n in ("q4_0", "f16")})
    phase_line("timing", t0, card=smi, **tm)

    bounds = kernel_bounds(chk)
    v = tm["vision"]

    def row(name, source, replaces, path, ms, plain_ms, err, bound_key, library_ms=None):
        ms_bound, by = bounds[bound_key]
        lib = library_ms if isinstance(library_ms, float) else None
        return dict(name=name, route="cuda", source=f"clip_tpu_torch/csrc/{source}",
                    replaces=f"clip_tpu/ops/{replaces}", launches=paths[path]["launches"][name],
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=ms_bound, bound_by=by,
                    library_ms=lib)

    kernels = [
        row("attn_block", "attention.cu", "attention_pallas.py:484", "q4_0", v["attn_block_ms"],
            v["attn_block_plain_ms"], chk["vision"]["attn_block_err"], "attn_block"),
        row("mlp_lnq", "actquant.cu", "actquant_pallas.py:362", "q4_0", v["mlp_lnq_ms"],
            v["mlp_lnq_plain_ms"], chk["vision"]["mlp_lnq_err"], "mlp_lnq"),
        row("qmatmul_q4", "qmatmul.cu", "qmatmul_pallas.py:69", "q4_0", tm["qmatmul_q4_0_ms"],
            tm["qmatmul_q4_0_plain_ms"], chk["qmatmul_q4_0_m64_err"], "qmatmul_q4_0"),
        row("qmatmul_q5", "qmatmul.cu", "qmatmul_pallas.py:103", "q5_1", tm["qmatmul_q5_1_ms"],
            tm["qmatmul_q5_1_plain_ms"], max(chk["qmatmul_q5_1_m64_err"],
                                             chk["qmatmul_q5_0_m64_err"]), "qmatmul_q5_1"),
        row("qmatmul_q8", "qmatmul.cu", "qmatmul_pallas.py:151", "q8_0", tm["qmatmul_q8_0_ms"],
            tm["qmatmul_q8_0_plain_ms"], chk["qmatmul_q8_0_m64_err"], "qmatmul_q8_0"),
        row("mha_qkv", "attention.cu", "attention_pallas.py:1014", "f16",
            tm["mha_qkv_vision_ms"], tm["mha_qkv_vision_plain_ms"],
            chk["mha_qkv_vision_err"], "mha_qkv_vision", tm["sdpa_vision_ms"]),
    ]
    say(f"[total] {time.perf_counter() - T_START:.2f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
