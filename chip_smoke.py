#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. environment: torch/CUDA versions, compute capability 9.x, the card's
     name and power limit from nvidia-smi;
  2. build: the port's CUDA kernel from the sources in this checkout
     (nvcc, sm_90a);
  3. kernels vs plain: each kernel at the serving path's shapes against
     its plain PyTorch version on the same inputs, with times for the
     kernel, the plain version and one PyTorch library call, and the
     least time the card could take (its bound);
  4. model: Llama-3-8B at full width, 2 layers, forward() logits with the
     kernel against the plain attention;
  5. serve: LLMServer on Llama-3-8B (full width, 32 layers, random bf16
     weights from a seed), a registered 64-token prefix, 16 concurrent
     requests of 100-1000 tokens, greedy and sampled, some extending the
     prefix; the kernel must have run in full and in suffix prefill.
The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}. Without CUDA it exits with
status 2 and prints no result.

    python3 chip_smoke.py --profile DIR

also profiles the serve phase (torch.profiler) and prints where its
device time went by kernel class, and the device's idle share.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Published peaks of one H100 SXM (dense): bf16 on the tensor cores, f32
# on the CUDA cores, and device memory bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of the kernel against its plain version (phase 3).
F32_ATOL = 2e-5        # f32: same arithmetic, sums in another order
LSE_ATOL = 1e-4        # lse is f32 from exact bf16 products in any case
# bf16, against the plain version run in f32 on the same bf16 inputs: the
# kernel rounds P to bf16 before P.V (as the TPU kernel does) and rounds O
# to bf16, each to nearest, so at most 2^-8 relative (half an ulp). The
# P.V term errs by at most 2^-8 * sum(p|v|)/l, and its per-key errors
# are of independent sign; O's rounding adds 2^-8 * |O|, where |O| (an
# average of v over the visible keys) is well below max|v| but in the
# first rows. Held to one unit roundoff of the largest |v|.
BF16_REL_V = 2.0 ** -8
# Phase 4: bf16 logits may differ by a few bf16 ulps of the largest
# logit (the residual stream differs by the attention's rounding).
LOGITS_REL = 2.0 ** -5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(Sq: int, Skv: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the mask lets through: the work this input
    needs."""
    if not causal:
        return Sq * Skv
    return sum(min(Skv, max(0, q_offset + i + 1)) for i in range(Sq))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_env() -> dict:
    cap = torch.cuda.get_device_capability(0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"capability {cap[0]}.{cap[1]} count {torch.cuda.device_count()}")
    if cap[0] != 9:
        raise RuntimeError(f"need a Hopper card (9.x), got {cap}")
    card = card_line()
    log(f"[env] card: {card}")
    return {"card": card}


def phase_build() -> None:
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.flash_attention import SOURCE

    t0 = time.perf_counter()
    _build.load(SOURCE)
    report = _build.build_log.get(SOURCE)
    log(f"[build] {SOURCE} {'built' if report is not None else 'cached'} "
        f"and loaded in {time.perf_counter() - t0:.2f} s")
    for line in (report or "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {SOURCE}: {line.strip()}")


def _sdpa(q, k, v, causal, q_offset):
    """One PyTorch library call computing the same attention (timed as
    the yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not causal:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      enable_gqa=True)
    if q_offset == 0 and q.shape[1] == k.shape[1]:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    qp = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = qp >= kp
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  enable_gqa=True)


def phase_kernels() -> dict:
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # (name, B, Sq, Skv, H, KVH, D, dtype, q_offset): the serving path's
    # shapes — 8-row prefill tiles at the 512 and 1024 buckets (the serve
    # phase's prompts fall in both; 1024 is the largest it runs), suffix
    # tiles behind a 64-token prefix at the 128 and 1024 buckets, a
    # ragged length, a prefix registration — and an f32 case.
    cases = [
        ("prefill", 8, 512, 512, 32, 8, 128, torch.bfloat16, 0),
        ("prefill_1024", 8, 1024, 1024, 32, 8, 128, torch.bfloat16, 0),
        ("suffix", 8, 128, 192, 32, 8, 128, torch.bfloat16, 64),
        ("suffix_1024", 8, 1024, 1088, 32, 8, 128, torch.bfloat16, 64),
        ("ragged", 8, 100, 100, 32, 8, 128, torch.bfloat16, 0),
        ("prefix_reg", 1, 64, 64, 32, 8, 128, torch.bfloat16, 0),
        ("f32", 8, 512, 512, 32, 8, 128, torch.float32, 0),
    ]
    rows = {}
    for name, B, Sq, Skv, H, KVH, D, dt, qo in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        q, k, v = rnd(B, Sq, H, D), rnd(B, Skv, KVH, D), rnd(B, Skv, KVH, D)
        out, lse = flash_attention_fwd(q, k, v, causal=True, q_offset=qo)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q.float(), k.float(),
                                             v.float(), causal=True,
                                             q_offset=qo)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = (F32_ATOL if dt == torch.float32
               else BF16_REL_V * v.float().abs().max().item())
        if not (err <= tol and lse_err <= LSE_ATOL
                and torch.isfinite(out).all()):
            raise RuntimeError(f"[kernels] {name}: max|dO| {err:.3e} (tol "
                               f"{tol:.3e}), max|dlse| {lse_err:.3e} (tol "
                               f"{LSE_ATOL:.0e})")
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True,
                                                 q_offset=qo), 50)
        plain_ms = cuda_ms(lambda: flash_attention_plain(
            q, k, v, causal=True, q_offset=qo), 10)
        library_ms = cuda_ms(_sdpa(q, k, v, True, qo), 50)
        es = q.element_size()
        flops = 4 * B * H * D * visible_pairs(Sq, Skv, True, qo)
        nbytes = (2 * B * Sq * H * D + 2 * B * Skv * KVH * D) * es \
            + B * H * Sq * 4
        t_ops = flops / PEAK_FLOPS[dt] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = {"shape": f"q({B},{Sq},{H},{D}) kv({B},{Skv},{KVH},{D}) "
                        f"{str(dt).split('.')[-1]} q_offset={qo}",
               "max_abs_err": err, "tol": tol, "lse_err": lse_err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / (ms * 1e-3) / 1e12}
        rows[name] = row
        log(f"[kernels] {name}: " + json.dumps(row))
    return rows


def phase_model() -> None:
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.models.transformer import forward, init_params

    cfg = dataclasses.replace(configs.llama3_8b(), n_layers=2)
    params = init_params(cfg, 1, device="cuda")
    toks = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 384)))
    kern = forward(cfg, params, toks)[0][:, -1]
    plain = forward(dataclasses.replace(cfg, attn_impl="reference"),
                    params, toks)[0][:, -1]
    torch.cuda.synchronize()
    err = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    tol = LOGITS_REL * scale
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"[model] llama3-8b width, 2 layers, tokens (2, 384): last-token "
        f"logits max|d| {err:.4e} (tol {tol:.4e} = 2^-5 * max|logit| "
        f"{scale:.3f}); argmax agreement {agree:.2f}")
    if not (err <= tol and torch.isfinite(kern).all()):
        raise RuntimeError("[model] kernel and plain attention disagree")
    del params
    torch.cuda.empty_cache()


def report_profile(prof, wall_s: float, out_dir: str) -> None:
    """Where the serve phase's device time went: kernel time by kernel
    class and the top kernels, and the share of the (profiled, so
    longer) wall time with no kernel running. The full table goes to
    out_dir/serve_profile.txt."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_class, by_name = {}, {}
    for e in kernels:
        n = e.name
        low = n.lower()
        cls = ("flash_attn_fwd" if "fwd_bf16_mma" in n or "fwd_f32_fma" in n
               else "memcpy/memset" if "memcpy" in low or "memset" in low
               else "gemm/gemv" if any(t in low for t in (
                   "gemm", "gemv", "nvjet", "cutlass", "xmma"))
               else "copy/cast" if "copy" in low
               else "reduce/softmax" if "reduce" in low or "softmax" in low
               else "index/gather/scatter" if any(t in low for t in (
                   "index", "gather", "scatter"))
               else "elementwise" if "elementwise" in low
               else "other")
        us = e.time_range.elapsed_us()
        by_class[cls] = by_class.get(cls, 0.0) + us
        cnt, tot = by_name.get(n, (0, 0.0))
        by_name[n] = (cnt + 1, tot + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    report = {
        "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernels_launched": len(kernels),
        "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()},
        "top_kernels": [{"name": n[:90], "count": c, "ms": us / 1e3}
                        for n, (c, us) in top]}
    log("[profile] " + json.dumps(report))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "serve_profile.txt"), "w") as f:
        f.write(json.dumps(report, indent=1) + "\n\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=60))


def phase_serve(counter, profile_dir: str = "") -> dict:
    from ray_tpu_torch.models import configs, generate
    from ray_tpu_torch.serve.llm import LLMServer

    cfg = configs.llama3_8b()
    t0 = time.perf_counter()
    server = LLMServer(cfg, seed=0, num_slots=8, max_seq_len=2048)
    torch.cuda.synchronize()
    log(f"[serve] LLMServer(llama3_8b) up in {time.perf_counter() - t0:.1f} s"
        f" (weights {torch.cuda.memory_allocated() / 2**30:.1f} GiB)")

    # Attribute kernel launches, and the device time between CUDA events
    # recorded around each call, to the outermost generate path that made
    # them (only the engine thread launches while requests run;
    # registration runs before them on this thread).
    keys = ("full_prefill", "suffix_prefill", "prefix_register",
            "first_token", "decode")
    by_path = dict.fromkeys(keys, 0)
    spans = {k: [] for k in keys}
    active = []
    for attr, key in (("_prefill_batch_core", "full_prefill"),
                      ("_prefill_suffix_core", "suffix_prefill"),
                      ("_prefill_core", "prefix_register"),
                      ("_first_token_logits", "first_token"),
                      ("_suffix_forward", "first_token"),
                      ("_decode_core", "decode")):
        fn = getattr(generate, attr)

        def counted(*a, _fn=fn, _key=key, **kw):
            if active:                    # nested: the outer path owns it
                return _fn(*a, **kw)
            active.append(_key)
            before = counter.count
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = _fn(*a, **kw)
            ev[1].record()
            spans[_key].append(ev)
            by_path[_key] += counter.count - before
            active.pop()
            return out
        setattr(generate, attr, counted)

    rng = np.random.RandomState(0)
    prefix = [int(t) for t in rng.randint(0, cfg.vocab_size, size=64)]
    prompts, temps = [], []
    for i in range(16):
        n = int(rng.randint(100, 1001))
        body = [int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
        prompts.append(prefix + body[64:] if i % 2 == 0 else body)
        temps.append(0.0 if i % 4 < 2 else 0.7)

    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile_dir
        else contextlib.nullcontext())
    counter.reset()                       # main path starts here
    t0 = time.perf_counter()
    with prof:
        server.register_prefix(prefix)
        with ThreadPoolExecutor(max_workers=len(prompts)) as pool:
            futs = [pool.submit(server.generate, p, max_new_tokens=32,
                                temperature=t)
                    for p, t in zip(prompts, temps)]
            results = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.count              # main path ends here
    if profile_dir:
        report_profile(prof, wall, profile_dir)
    stats = server.stats()
    server.stop()

    for p, r in zip(prompts, results):
        toks = r["tokens"]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"[serve] bad output for a {len(p)}-token "
                               f"prompt: {toks}")
    if by_path["full_prefill"] <= 0 or by_path["suffix_prefill"] <= 0:
        raise RuntimeError(f"[serve] kernel not launched on both prefill "
                           f"paths: {by_path}")
    if stats["prefix_hits"] < 1:
        raise RuntimeError(f"[serve] no request took the prefix path: "
                           f"{stats}")
    device_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
                for k, v in spans.items()}
    ttfts = sorted(r["ttft_s"] for r in results)
    decode_rates = sorted((len(r["tokens"]) - 1) / r["decode_s"]
                          for r in results if r["decode_s"] > 0)
    new_tokens = sum(len(r["tokens"]) for r in results)
    summary = {
        "requests": len(results), "prompt_lens": sorted(map(len, prompts)),
        "wall_s": wall, "ttft_p50_s": ttfts[len(ttfts) // 2],
        "ttft_max_s": ttfts[-1],
        "decode_tok_s_per_request_p50": decode_rates[len(decode_rates) // 2],
        "output_tok_s": new_tokens / wall, "kernel_launches": launches,
        "launches_by_path": by_path,
        "device_span_s_by_path": device_s,
        "calls_by_path": {k: len(v) for k, v in spans.items()},
        "device_span_share_of_wall": sum(device_s.values()) / wall,
        "prefix_hits": stats["prefix_hits"],
        "decode_ticks": stats["decode_ticks"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("[serve] " + json.dumps(summary))
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from ray_tpu_torch.ops.flash_attention import fwd_launches

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default="",
                    help="profile the serve phase with torch.profiler and "
                         "write its breakdown to DIR/serve_profile.txt")
    profile_dir = ap.parse_args().profile
    t_start = time.perf_counter()
    env = phase_env()
    phase_build()
    rows = phase_kernels()
    phase_model()
    serve = phase_serve(fwd_launches, profile_dir)
    main_row = rows["prefill_1024"]       # the largest bucket served
    kernels = {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attn_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:55",
        "launches": serve["kernel_launches"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(env["card"])
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
