#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``clip_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one flushed line with its wall seconds:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the kernels of ``clip_tpu_torch/csrc`` in one ``nvcc`` call, with
   the ``-Xptxas -v`` register and spill summary;
3. kernels: every kernel wrapper against its plain PyTorch version on the
   card, at the main path's shapes (ViT-B/32: vision rows 64 x 50, text rows
   8 x 80 causal, projection M = 64 with a q4_0 [512, 768] weight);
4. main path: a seeded random q4_0 ViT-B/32 two-tower GGUF in a temporary
   directory, ``ClipEngine`` on CUDA, image encode of 64 images, text encode
   of 8 prompts and one zero-shot labeling; every launch counter must rise by
   the count the path implies, the embeddings must be finite and unit-norm
   and agree (cos > 0.999) with the same engine forced onto its plain
   versions in float32;
5. timing (reported, not gated): each kernel, its plain version and the
   vision encode at B = 256.

It then prints the ``kernels`` JSON line, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises and the script exits nonzero.  It exits nonzero, with no result,
where no CUDA device is present or the package is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

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
    """Phase 3: every wrapper against its plain version, at the main path's
    shapes.  Returns the inputs and errors that phase 5 times."""
    import torch

    from clip_tpu_torch.gguf.constants import GGMLType
    from clip_tpu_torch.ops import actquant as aq
    from clip_tpu_torch.ops import attention as at
    from clip_tpu_torch.ops.nn import layernorm_f32
    from clip_tpu_torch.ops.qmatmul import qmatmul_q4, qmatmul_q4_plain
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

    # q4 dequant-GEMM at the projection's shape, q4_0 and q4_1
    for qtype in (GGMLType.Q4_1, GGMLType.Q4_0):
        wq = from_ggml_blocks(quantize(rng.normal(0, 0.02, (512, 768)).astype(np.float32), qtype),
                              (512, 768), qtype).to(device)
        xq = torch.from_numpy(rng.normal(0, 1, (64, 768)).astype(np.float32)).to(device)
        xq = xq.to(torch.bfloat16)
        y, y_p = qmatmul_q4(xq, wq).float(), qmatmul_q4_plain(xq, wq).float()
        err = float((y - y_p).abs().max())
        expect(bool(torch.allclose(y, y_p, rtol=2e-2, atol=2e-2)), f"qmatmul {qtype.name}: {err}")
        out[f"qmatmul_{qtype.name.lower()}_err"] = err
    if fails:
        raise AssertionError("kernel checks failed:\n  " + "\n  ".join(fails))
    out["qmatmul_args"] = (xq, wq)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out


def main_path(device, tmp: str) -> dict:
    """Phase 4: the engine end to end, kernels against the plain route."""
    import torch

    from clip_tpu_torch import ops
    from clip_tpu_torch.engine import ClipEngine
    from clip_tpu_torch.synth import make_synthetic_gguf

    t0 = time.perf_counter()
    path = make_synthetic_gguf(os.path.join(tmp, "vit-b-32_q4_0.gguf"), "ViT-B/32",
                               ftype="q4_0", seed=0)
    eng = ClipEngine(path, verbosity=0)
    assert eng.device.type == "cuda" and eng.compute_dtype == torch.bfloat16
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    images = [(rng.random((256, 320, 3)) * 255).astype(np.uint8) for _ in range(64)]
    prompts = ["a photo of a cat", "a photo of a dog", "a red apple", "the white cat",
               "an apple", "a dog", "a photo of the red dog", "white"]
    labels = ["cat", "dog", "apple"]

    ops.reset_launches()
    t1 = time.perf_counter()
    img = eng.encode_image(images)
    txt = eng.encode_text(prompts)
    zsl = eng.zero_shot_label_image(images[0], labels)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = ops.launches()

    nv, nt = eng.config.vision.n_layer, eng.config.text.n_layer
    # image 64, text 8, zero-shot: image 1 + text of 3 labels (bucket 4)
    expect = {"attn_block": 2 * nv + 2 * nt, "mlp_lnq": 2 * nv + 2 * nt, "qmatmul_q4": 4}
    for name, n in expect.items():
        assert launches[name] == n, f"{name}: {launches[name]} launches, expected {n}"
    for name, emb in (("image", img), ("text", txt)):
        assert np.isfinite(emb).all(), f"{name} embeddings not finite"
        norms = np.linalg.norm(emb, axis=1)
        assert np.abs(norms - 1).max() < 1e-2, f"{name} norms {norms}"

    ref = ClipEngine(path, compute_dtype="float32", kernels=False, verbosity=0)
    img_r = ref.encode_image(images)
    txt_r = ref.encode_text(prompts)
    zsl_r = ref.zero_shot_label_image(images[0], labels)
    c_img = float((img * img_r).sum(1).min())
    c_txt = float((txt * txt_r).sum(1).min())
    assert c_img > 0.999, f"image embeddings vs plain f32: min cos {c_img}"
    assert c_txt > 0.999, f"text embeddings vs plain f32: min cos {c_txt}"
    del ref
    torch.cuda.empty_cache()
    return dict(engine=eng, launches=launches, expect=expect, load_s=load_s, run_s=run_s,
                image_min_cos=c_img, text_min_cos=c_txt,
                zsl=[zsl[1].tolist(), zsl[0].tolist()], zsl_plain=[zsl_r[1].tolist(),
                                                               zsl_r[0].tolist()])


def kernel_bounds(chk: dict) -> dict:
    b, s, h, nh, f = chk["vision"]["shape"]
    rows, dh = b * s, h // nh
    vecs = lambda n: 4 * n  # noqa: E731  (f32 vector bytes)
    attn = bound(2 * rows * h * 2 + 4 * h * h + 2 * vecs(h) + 2 * vecs(3 * h) + 2 * vecs(h),
                 int8_ops=2 * rows * 4 * h * h, bf16_flops=4 * b * nh * s * s * dh)
    mlp = bound(2 * rows * h * 2 + 2 * f * h + 2 * vecs(h) + 2 * vecs(f) + 2 * vecs(h),
                int8_ops=2 * rows * 2 * f * h)
    xq, wq = chk["qmatmul_args"]
    m, k = xq.shape
    n = wq.shape[0]
    qmm = bound(m * k * 2 + n * k // 2 + 4 * n * k // 32 + m * n * 2, bf16_flops=2 * m * n * k)
    return {"attn_block": attn, "mlp_lnq": mlp, "qmatmul_q4": qmm}


def timing(device, chk: dict, eng) -> dict:
    """Phase 5: device times of each kernel and its plain version at the
    main path's vision shapes, and the encode rate at B = 256."""
    import torch
    import torch.nn.functional as F

    from clip_tpu_torch.models.vision import encode_image
    from clip_tpu_torch.ops import actquant as aq
    from clip_tpu_torch.ops import attention as at
    from clip_tpu_torch.ops.qmatmul import qmatmul_q4, qmatmul_q4_plain

    res: dict = {}
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
    xq, wq = chk["qmatmul_args"]
    res["qmatmul_q4_ms"] = graph_ms(lambda: qmatmul_q4(xq, wq))
    res["qmatmul_q4_plain_ms"] = graph_ms(lambda: qmatmul_q4_plain(xq, wq))
    res["qmatmul_q4_eager_ms"] = cuda_ms(lambda: qmatmul_q4(xq, wq))

    # vision encode at B = 256: engine call from host float pixels (includes
    # the host->device copy and the readback), and the tower alone on
    # pixels already on the card
    rng = np.random.default_rng(2)
    pixels = rng.normal(0, 1, (256, 224, 224, 3)).astype(np.float32)
    eng.encode_image(pixels)
    host_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.encode_image(pixels)
        host_s.append(time.perf_counter() - t0)
    px = torch.from_numpy(pixels).to(device).to(torch.bfloat16)

    def tower():
        with torch.inference_mode():
            return encode_image(eng.params["vision"], eng.config.vision, px,
                                use_gelu=eng.config.use_gelu, compute_dtype=torch.bfloat16)

    dev_ms = [cuda_ms(tower, iters=1, warmup=1 if i == 0 else 0) for i in range(5)]
    res["vision_b256_profile"] = profile_kernels(tower)
    res["vision_b256"] = {
        "engine_median_s": statistics.median(host_s), "engine_runs_s": host_s,
        "engine_images_per_s": 256 / statistics.median(host_s),
        "tower_median_ms": statistics.median(dev_ms), "tower_runs_ms": dev_ms,
        "tower_images_per_s": 256 / (statistics.median(dev_ms) / 1e3),
    }
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
               torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    info = _cuda.build(force=True)
    _cuda.lib()
    say("[ptxas]\n" + info.ptxas)
    phase_line("build", t0, nvcc_seconds=round(info.seconds, 2), nvcc_calls=1)

    t0 = time.perf_counter()
    chk = check_kernels(device)
    summary = {t: {k: v for k, v in chk[t].items() if k.endswith(("cos", "err", "mismatch"))}
               for t in ("vision", "text")}
    summary.update({k: v for k, v in chk.items() if k.startswith("qmatmul_q4")})
    phase_line("kernels", t0, **summary)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp = main_path(device, tmp)
    phase_line("main_path", t0, launches=mp["launches"], expected=mp["expect"],
               load_s=round(mp["load_s"], 2), run_s=round(mp["run_s"], 2),
               image_min_cos=mp["image_min_cos"], text_min_cos=mp["text_min_cos"],
               zsl=mp["zsl"], zsl_plain=mp["zsl_plain"])

    t0 = time.perf_counter()
    tm = timing(device, chk, mp["engine"])
    phase_line("timing", t0, card=smi, **tm)

    bounds = kernel_bounds(chk)
    v = tm["vision"]
    kernels = [
        dict(name="attn_block", route="cuda", source="clip_tpu_torch/csrc/attention.cu",
             replaces="clip_tpu/ops/attention_pallas.py:484",
             launches=mp["launches"]["attn_block"], max_abs_err=chk["vision"]["attn_block_err"],
             ms=v["attn_block_ms"], plain_ms=v["attn_block_plain_ms"],
             bound_ms=bounds["attn_block"][0], bound_by=bounds["attn_block"][1],
             library_ms=None),
        dict(name="mlp_lnq", route="cuda", source="clip_tpu_torch/csrc/actquant.cu",
             replaces="clip_tpu/ops/actquant_pallas.py:362",
             launches=mp["launches"]["mlp_lnq"], max_abs_err=chk["vision"]["mlp_lnq_err"],
             ms=v["mlp_lnq_ms"], plain_ms=v["mlp_lnq_plain_ms"],
             bound_ms=bounds["mlp_lnq"][0], bound_by=bounds["mlp_lnq"][1], library_ms=None),
        dict(name="qmatmul_q4", route="cuda", source="clip_tpu_torch/csrc/qmatmul.cu",
             replaces="clip_tpu/ops/qmatmul_pallas.py:172",
             launches=mp["launches"]["qmatmul_q4"], max_abs_err=chk["qmatmul_q4_0_err"],
             ms=tm["qmatmul_q4_ms"], plain_ms=tm["qmatmul_q4_plain_ms"],
             bound_ms=bounds["qmatmul_q4"][0], bound_by=bounds["qmatmul_q4"][1],
             library_ms=None),
    ]
    say(f"[total] {time.perf_counter() - T_START:.2f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
