#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. environment: torch/CUDA versions, compute capability 9.x, the card's
     name and power limit from nvidia-smi;
  2. build: the port's CUDA kernels from the sources in this checkout
     (nvcc, sm_90a), each source timed, with ptxas's register and spill
     report;
  3. forward kernel vs plain: the attention forward at the serving and
     training shapes, at D 64, non-causal and ragged, and with rows that
     see no key (exactly 0), against its plain PyTorch version on the
     same inputs, with the kernel and one PyTorch library call (SDPA)
     timed in turns (median and range of each), the plain version's
     time, and the least time the card could take (its bound);
  4. backward kernels vs plain: dq and dk/dv at the training shape and
     at suffix, ragged, fully-masked-row, D 64, non-causal and f32
     shapes against the plain backward (blind rows' grads exactly 0, two
     launches bit-identical at the training shape), with each kernel's
     time, the pair's against SDPA's backward in turns, and the plain
     backward's;
  5. model: Llama-3-8B at full width, 2 layers, forward() logits with the
     kernel against the plain attention;
  6. model grads: llama-654m at full width, 2 layers, bf16, the grads of
     loss_fn with the kernels against the plain attention;
  7. train: llama-654m (full width, 16 layers, f32 master weights, remat)
     through init_state/make_train_step, 6 steps on one batch of 8 x 1024
     tokens: the loss falls, and every step launches the forward kernel
     twice per layer (forward and remat's recompute) and dq and dk/dv
     once per layer;
  8. serve: LLMServer on Llama-3-8B (full width, 32 layers, random bf16
     weights from a seed), a registered 64-token prefix, 16 concurrent
     requests of 100-1000 tokens, greedy and sampled, some extending the
     prefix; the kernel must have run in full and in suffix prefill.
The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}. Without CUDA it exits with
status 2 and prints no result.

    python3 chip_smoke.py --profile DIR

also profiles one more train step and the serve phase (torch.profiler),
prints where their device time went by kernel class and the device's
idle share, and writes DIR/train_profile.txt and DIR/serve_profile.txt.

    python3 chip_smoke.py --serve-ab PARENT
    python3 chip_smoke.py --train-ab PARENT

run only the serve (or train) phase, each time in a fresh process, in
the checkout at PARENT (another commit of the port, unpacked with git
archive) and in this one in turns, 3 rounds of 4 runs, and print each
run's serving (or training) metrics and each side's median and range.
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
# Phase 4, bf16 backward against the plain backward run in f32 on the
# same bf16 inputs (and the same O and lse). Each of dq, dk and dv
# differs by (a) the rounding of the result to bf16, at most 2^-8 of its
# largest element, and (b) the rounding of P (for dV) and dS (for dQ,
# dK) to bf16 before the products, as the TPU kernels round them: each
# term is off by at most 2^-8 relative, with independent signs over the
# hundreds to thousands of terms of a sum, so the sum is off by far less
# than 2^-8 of its terms' magnitudes; bounded here by another 2^-8 of
# the largest element. f32 sums in another order are negligible beside
# both. Held to 2^-7 of the largest |grad| of each output; f32 inputs
# to 2e-5, as the forward.
BWD_BF16_REL = 2.0 ** -7
# Phase 5: bf16 logits may differ by a few bf16 ulps of the largest
# logit (the residual stream differs by the attention's rounding).
LOGITS_REL = 2.0 ** -5
# Phase 6: per-leaf relative L2 error of bf16 grads, kernels against
# plain attention. The two runs round differently inside attention
# (forward and backward), and every later bf16 activation and grad
# carries that difference at ~2^-8 relative; eight bf16 units of
# roundoff bound the relative L2 difference of each leaf.
GRAD_REL_L2 = 2.0 ** -5


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


def in_turns(kernel, library, iters: int, rounds: int = 3) -> dict:
    """A kernel and its library call timed in turns in this process:
    kernel, library, library, kernel for `rounds` rounds, each turn one
    cuda_ms of `iters` launches. -> each side's median and range, and
    the ratio of the medians (kernel / library)."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kernel, iters))
        ls.append(cuda_ms(library, iters))
        ls.append(cuda_ms(library, iters))
        ks.append(cuda_ms(kernel, iters))
    ms, lib = float(np.median(ks)), float(np.median(ls))
    return {"ms": ms, "ms_range": [min(ks), max(ks)], "library_ms": lib,
            "library_ms_range": [min(ls), max(ls)], "ratio": ms / lib}


def visible_pairs(Sq: int, Skv: int, causal: bool, q_offset: int,
                  kv_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through: the work this input
    needs."""
    if not causal:
        return Sq * Skv
    return sum(min(Skv, max(0, q_offset - kv_offset + i + 1))
               for i in range(Sq))


def bound(flops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate for their type and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
    """Build every source at once (one nvcc each, started together), each
    timed, with ptxas's report: the kernel each line is about, its
    registers, shared memory and spills, and any warning (a wgmma
    pipeline that ptxas serialised shows here)."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.flash_attention import BWD_SOURCE, SOURCE

    def build(src):
        t0 = time.perf_counter()
        _build.load(src)
        return time.perf_counter() - t0

    srcs = (SOURCE, BWD_SOURCE)
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        took = list(pool.map(build, srcs))
    for src, s in zip(srcs, took):
        report = _build.build_log.get(src)
        log(f"[build] {src} {'built' if report is not None else 'cached'} "
            f"and loaded in {s:.2f} s")
        for line in (report or "").splitlines():
            if "Compiling entry" in line:
                log(f"[build] {src}: {line.split(chr(39))[1]}")
            elif any(w in line for w in ("registers", "spill", "smem",
                                         "arning", "Potential")):
                log(f"[build] {src}:   {line.strip()}")


def _sdpa(q, k, v, causal, q_offset, kv_offset=0):
    """One PyTorch library call computing the same attention (timed as
    the yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not causal:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      enable_gqa=True)
    if q_offset == kv_offset and q.shape[1] == k.shape[1]:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    qp = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kp = kv_offset + torch.arange(k.shape[1], device=q.device)[None, :]
    mask = qp >= kp
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  enable_gqa=True)


def _sdpa_bwd(q, k, v, do, causal, q_offset, kv_offset):
    """The backward alone of that library call (the yardstick of the
    backward kernels)."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = _sdpa(q, k, v, causal, q_offset, kv_offset)()
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (q, k, v), dot,
                                       retain_graph=True)


# Phase 3's cases: (name, B, Sq, Skv, H, KVH, D, dtype, causal, q_offset,
# kv_offset). The serving path's shapes: 8-row prefill tiles at the 512
# and 1024 buckets (the serve phase's prompts fall in both; 1024 is the
# largest it runs), suffix tiles behind a 64-token prefix at the 128 and
# 1024 buckets, a ragged length, a prefix registration. The training
# path's shape (llama-654m, 8 x 1024 tokens). gpt2_125m's head size (D
# 64, MHA), a non-causal ragged ViT-B/16 token count (197), rows that
# see no key (kv_offset 64: the first 64 rows must give exactly 0), the
# training shape with q, k and v cut by head out of one fused
# (B, S, H + 2 KVH, D) projection (strided views read in place), and
# f32.
FWD_CASES = [
    ("train", 8, 1024, 1024, 12, 4, 128, torch.bfloat16, True, 0, 0),
    ("fused_qkv", 8, 1024, 1024, 12, 4, 128, torch.bfloat16, True, 0, 0),
    ("prefill", 8, 512, 512, 32, 8, 128, torch.bfloat16, True, 0, 0),
    ("prefill_1024", 8, 1024, 1024, 32, 8, 128, torch.bfloat16, True, 0, 0),
    ("suffix", 8, 128, 192, 32, 8, 128, torch.bfloat16, True, 64, 0),
    ("suffix_1024", 8, 1024, 1088, 32, 8, 128, torch.bfloat16, True, 64, 0),
    ("ragged", 8, 100, 100, 32, 8, 128, torch.bfloat16, True, 0, 0),
    ("prefix_reg", 1, 64, 64, 32, 8, 128, torch.bfloat16, True, 0, 0),
    ("d64", 8, 1024, 1024, 12, 12, 64, torch.bfloat16, True, 0, 0),
    ("noncausal_197", 8, 197, 197, 12, 12, 64, torch.bfloat16, False, 0, 0),
    ("masked_rows", 2, 128, 128, 12, 4, 128, torch.bfloat16, True, 0, 64),
    ("f32", 8, 512, 512, 32, 8, 128, torch.float32, True, 0, 0),
]


def phase_kernels() -> dict:
    """The forward kernel against its plain version (run in f32 on the
    same inputs) in every case of FWD_CASES, with the kernel and SDPA
    timed in turns, the plain version's time, and the bound."""
    from ray_tpu_torch.ops.flash_attention import (
        _aligned, flash_attention_fwd, flash_attention_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for name, B, Sq, Skv, H, KVH, D, dt, causal, qo, ko in FWD_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        if name == "fused_qkv":
            qkv = rnd(B, Sq, H + 2 * KVH, D)
            q, k, v = (qkv[:, :, :H], qkv[:, :, H:H + KVH],
                       qkv[:, :, H + KVH:])
            if not all(_aligned(x) and not x.is_contiguous()
                       for x in (q, k, v)):
                raise RuntimeError("[kernels] fused_qkv: views not taken "
                                   "in place")
        else:
            q, k, v = (rnd(B, Sq, H, D), rnd(B, Skv, KVH, D),
                       rnd(B, Skv, KVH, D))
        kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q.float(), k.float(),
                                             v.float(), **kw)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = (F32_ATOL if dt == torch.float32
               else BF16_REL_V * v.float().abs().max().item())
        # Rows that see no key: every output exactly 0.
        blind = max(0, min(Sq, ko - qo)) if causal else 0
        blind_zero = bool((out[:, :blind] == 0).all())
        if not (err <= tol and lse_err <= LSE_ATOL and blind_zero
                and torch.isfinite(out).all()):
            raise RuntimeError(f"[kernels] {name}: max|dO| {err:.3e} (tol "
                               f"{tol:.3e}), max|dlse| {lse_err:.3e} (tol "
                               f"{LSE_ATOL:.0e}), {blind} blind rows all 0 "
                               f"{blind_zero}, finite "
                               f"{bool(torch.isfinite(out).all())}")
        row = {"shape": f"q({B},{Sq},{H},{D}) kv({B},{Skv},{KVH},{D}) "
                        f"{str(dt).split('.')[-1]} causal={causal} "
                        f"q_offset={qo} kv_offset={ko}",
               "max_abs_err": err, "tol": tol, "lse_err": lse_err,
               "blind_rows": blind}

        def kernel():
            flash_attention_fwd(q, k, v, **kw)

        # SDPA gives NaN on rows that see no key: no yardstick there.
        turns = (in_turns(kernel, _sdpa(q, k, v, causal, qo, ko), 20)
                 if blind == 0 else
                 {"ms": cuda_ms(kernel, 50), "library_ms": None})
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), 10)
        es = q.element_size()
        flops = 4 * B * H * D * visible_pairs(Sq, Skv, causal, qo, ko)
        nbytes = (2 * B * Sq * H * D + 2 * B * Skv * KVH * D) * es \
            + B * H * Sq * 4
        row.update(turns, plain_ms=plain_ms, **bound(flops, nbytes, dt),
                   tflops=flops / (turns["ms"] * 1e-3) / 1e12)
        rows[name] = row
        log(f"[kernels] {name}: " + json.dumps(row))
    torch.cuda.empty_cache()
    return rows


def phase_bwd_kernels() -> dict:
    """dq and dk/dv against the plain backward (run in f32 on the same
    inputs), with each kernel's time (CUDA events, warm, launched through
    the wrapper's own launch helper, which counts nothing), the plain
    backward's and SDPA's backward's, and each kernel's bound. Rows that
    see no key, and kv rows that no query sees, must get grads of exactly
    0; at the training shape two launches of the pair must give
    bit-identical grads."""
    from ray_tpu_torch.ops.flash_attention import (
        _bwd_launch, _bwd_prepare, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_fwd)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    # (name, B, Sq, Skv, H, KVH, D, dtype, causal, q_offset, kv_offset):
    # the training shape (llama-654m, 8 x 1024 tokens, GQA 12/4), a GQA
    # suffix behind 64 positions, a ragged length, rows that see no key
    # (their grads must be finite: 0), gpt2_125m's head size (D 64, MHA),
    # a non-causal ragged ViT-B/16 token count (197), and f32.
    cases = [
        ("train", 8, 1024, 1024, 12, 4, 128, torch.bfloat16, True, 0, 0),
        ("suffix", 2, 512, 576, 12, 4, 128, torch.bfloat16, True, 64, 0),
        ("ragged", 8, 100, 100, 12, 4, 128, torch.bfloat16, True, 0, 0),
        ("masked_rows", 2, 512, 512, 12, 4, 128, torch.bfloat16, True, 0,
         64),
        ("d64", 8, 1024, 1024, 12, 12, 64, torch.bfloat16, True, 0, 0),
        ("noncausal_197", 8, 197, 197, 12, 12, 64, torch.bfloat16, False, 0,
         0),
        ("f32", 4, 512, 512, 12, 4, 128, torch.float32, True, 0, 0),
    ]
    rows = {}
    for name, B, Sq, Skv, H, KVH, D, dt, causal, qo, ko in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        q, k, v = rnd(B, Sq, H, D), rnd(B, Skv, KVH, D), rnd(B, Skv, KVH, D)
        do = rnd(B, Sq, H, D)
        kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, do, out, lse, **kw)
        torch.cuda.synchronize()
        ref = flash_attention_bwd_plain(
            *(x.float() for x in (q, k, v, do, out)), lse, **kw)
        # Query rows that see no key, and kv rows that no query sees.
        blind_q = max(0, min(Sq, ko - qo)) if causal else 0
        blind_kv = max(0, Skv - max(0, qo + Sq - ko)) if causal else 0
        blind_zero = bool((got[0][:, :blind_q] == 0).all()
                          and (got[1][:, Skv - blind_kv:] == 0).all()
                          and (got[2][:, Skv - blind_kv:] == 0).all())
        errs, tols = {}, {}
        for label, a, b in zip(("dq", "dk", "dv"), got, ref):
            errs[label] = (a.float() - b).abs().max().item()
            tols[label] = (F32_ATOL if dt == torch.float32
                           else BWD_BF16_REL * b.abs().max().item())
            if not (errs[label] <= tols[label] and blind_zero
                    and torch.isfinite(a).all()):
                raise RuntimeError(
                    f"[bwd] {name}: max|d{label}| {errs[label]:.3e} (tol "
                    f"{tols[label]:.3e}), {blind_q} blind q rows and "
                    f"{blind_kv} blind kv rows all 0 {blind_zero}, finite "
                    f"{bool(torch.isfinite(a).all())}")
        row = {"shape": f"q({B},{Sq},{H},{D}) kv({B},{Skv},{KVH},{D}) "
                        f"{str(dt).split('.')[-1]} causal={causal} "
                        f"q_offset={qo} kv_offset={ko}",
               "err": errs, "tol": tols, "blind_rows": [blind_q, blind_kv]}
        if name == "train":
            again = flash_attention_bwd(q, k, v, do, out, lse, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError("[bwd] train: two launches of the pair "
                                   "gave different grads")
            row["bit_identical"] = True
            del again

        # Each kernel alone, through the wrapper's own launch helper
        # (the wrapper counts its launches; the helper does not). dk/dv
        # reads the Delta that dq writes into the buffer of these
        # arguments, so it is timed after dq's launches, never alone.
        args, _grads, _keep = _bwd_prepare(
            q, k, v, do, out, lse, causal, 1.0 / D ** 0.5, qo, ko)
        iters = 20 if name == "train" else 50
        dq_ms = cuda_ms(lambda: _bwd_launch("flash_attn_bwd_dq", args,
                                            q.device), iters)
        dkv_ms = cuda_ms(lambda: _bwd_launch("flash_attn_bwd_dkv", args,
                                             q.device), iters)
        bwd_ms = cuda_ms(lambda: flash_attention_bwd(
            q, k, v, do, out, lse, **kw), iters)
        plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, do, out, lse, **kw), 5)

        def pair():
            _bwd_launch("flash_attn_bwd_dq", args, q.device)
            _bwd_launch("flash_attn_bwd_dkv", args, q.device)

        # dq and dk/dv together against SDPA's backward, in turns.
        turns = in_turns(pair, _sdpa_bwd(q, k, v, do, causal, qo, ko),
                         iters)
        es = q.element_size()
        pairs = B * H * visible_pairs(Sq, Skv, causal, qo, ko)
        q_bytes = B * Sq * H * D * es            # q, dO, O or dq
        kv_bytes = B * Skv * KVH * D * es        # k, v, dk or dv
        stat_bytes = 2 * B * H * Sq * 4          # lse and Delta
        row.update({
            "dq_ms": dq_ms, "dkv_ms": dkv_ms,
            "dq_tflops": 6 * D * pairs / (dq_ms * 1e-3) / 1e12,
            "dkv_tflops": 8 * D * pairs / (dkv_ms * 1e-3) / 1e12,
            "bwd_ms": bwd_ms, "plain_ms": plain_ms,
            "pair_ms": turns["ms"], "pair_ms_range": turns["ms_range"],
            "library_ms": turns["library_ms"],
            "library_ms_range": turns["library_ms_range"],
            "dq": bound(6 * D * pairs,
                        4 * q_bytes + 2 * kv_bytes + stat_bytes, dt),
            "dkv": bound(8 * D * pairs,
                         2 * q_bytes + 4 * kv_bytes + stat_bytes, dt)})
        rows[name] = row
        log(f"[bwd] {name}: " + json.dumps(row))
        del args, _grads, _keep, got, ref
    torch.cuda.empty_cache()
    return rows


def phase_model_grads() -> None:
    """llama-654m at full width, 2 layers, bf16 compute over f32 master
    weights, tokens (2, 512): per-leaf relative L2 error of loss_fn's
    grads with the kernels against the plain attention."""
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.models.transformer import init_params, loss_fn
    from ray_tpu_torch.ops.flash_attention import dkv_launches, dq_launches
    from ray_tpu_torch.train.step import _leaves, _rebuild

    cfg = dataclasses.replace(configs.llama_654m(), n_layers=2)
    params = init_params(cfg, 2, device="cuda", master_weights=True)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(2, 513))).cuda()
    tokens, targets = toks[:, :-1], toks[:, 1:]

    def grads(c):
        live = [p.detach().requires_grad_() for p in _leaves(params)]
        before = (dq_launches.count, dkv_launches.count)
        loss, _ = loss_fn(c, _rebuild(params, live), tokens, targets)
        gs = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        ran = (dq_launches.count - before[0], dkv_launches.count - before[1])
        return loss.item(), gs, ran

    k_loss, k_grads, k_ran = grads(cfg)
    p_loss, p_grads, p_ran = grads(dataclasses.replace(
        cfg, attn_impl="reference"))
    rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
           for a, b in zip(k_grads, p_grads)]
    finite = all(bool(torch.isfinite(g).all()) for g in k_grads)
    log(f"[grads] llama-654m width, 2 layers, bf16, tokens (2, 512): loss "
        f"{k_loss:.6f} (plain {p_loss:.6f}); per-leaf relative L2 error "
        f"max {max(rel):.3e} median {sorted(rel)[len(rel) // 2]:.3e} (tol "
        f"{GRAD_REL_L2:.3e}); launches dq/dkv {k_ran} (plain {p_ran})")
    if not (finite and max(rel) <= GRAD_REL_L2 and k_ran == (2, 2)
            and p_ran == (0, 0)):
        raise RuntimeError("[grads] kernel and plain attention disagree")
    del params, k_grads, p_grads
    torch.cuda.empty_cache()


def train_flops(cfg, B: int, S: int) -> dict:
    """FLOPs of one train step. Model FLOPs (what MFU counts): 6 per
    matmul weight per token (forward 2, backward 4) plus attention's 12*D
    per visible (query, key) pair and head (forward QK^T and PV, backward
    dS K, dS^T Q, dO V^T and P^T dO). Hardware FLOPs add remat's second
    forward of every layer and the backward kernels' recompute of
    QK^T."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    layer_w = (d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
               + 3 * d * cfg.d_ff)
    head_w = d * cfg.vocab_size
    T = B * S
    pairs = B * cfg.n_heads * visible_pairs(S, S, True, 0) * L
    model = 6 * (L * layer_w + head_w) * T + 12 * hd * pairs
    hardware = (8 * L * layer_w + 6 * head_w) * T + 22 * hd * pairs
    return {"model": model, "hardware": hardware}


def phase_train(profile_dir: str = "") -> dict:
    """llama-654m, 16 layers, through init_state / make_train_step: 6
    steps on one batch of 8 x 1024 seeded random tokens. The schedule's
    lr is 0 at step 0, so the loss must fall from step 1 to step 5."""
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.ops.flash_attention import (
        dkv_launches, dq_launches, fwd_launches)
    from ray_tpu_torch.train import init_state, make_optimizer, \
        make_train_step

    cfg = configs.llama_654m()
    B, S, steps = 8, 1024, 6
    opt = make_optimizer(lr=3e-4, warmup_steps=2, total_steps=100)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, opt, seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    targets = torch.roll(tokens, -1, 1)
    train_step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    log(f"[train] llama-654m ({cfg.num_params() / 1e6:.0f}M params, "
        f"{cfg.n_layers} layers) state up in {time.perf_counter() - t0:.1f}"
        f" s ({torch.cuda.memory_allocated() / 2**30:.1f} GiB)")

    counters = (fwd_launches, dq_launches, dkv_launches)
    want = [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]
    for c in counters:                    # main path starts here
        c.reset()
    per_step, times, metrics = [], [], []
    for _ in range(steps):
        before = [c.count for c in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append([c.count - b for c, b in zip(counters, before)])
        metrics.append(m)
    launches = {c.name: c.count for c in counters}   # main path ends here
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    step_s = float(np.median(times[2:]))
    flops = train_flops(cfg, B, S)
    summary = {
        "losses": losses, "grad_norms": gnorms, "step_s": times,
        "step_s_median_2_5": step_s, "tokens_per_s": B * S / step_s,
        "model_tflop_per_step": flops["model"] / 1e12,
        "hardware_tflop_per_step": flops["hardware"] / 1e12,
        "mfu": flops["model"] / step_s / PEAK_FLOPS[torch.bfloat16],
        "hfu": flops["hardware"] / step_s / PEAK_FLOPS[torch.bfloat16],
        "peak_mem_gib": peak / 2**30, "launches": launches,
        "launches_per_step": per_step}
    log("[train] " + json.dumps(summary))
    if not all(np.isfinite(losses + gnorms)):
        raise RuntimeError("[train] a loss or grad norm is not finite")
    if not losses[-1] < losses[1]:
        raise RuntimeError(f"[train] loss did not fall: {losses}")
    if any(n != want for n in per_step):
        raise RuntimeError(f"[train] launches per step {per_step}, want "
                           f"{want} (fwd, dq, dkv)")
    if profile_dir:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        t0 = time.perf_counter()
        with prof:
            state, _ = train_step(state, tokens, targets)
            torch.cuda.synchronize()
        report = report_profile(prof, time.perf_counter() - t0, profile_dir,
                                "train")
        by = report["device_ms_by_class"]
        attn = {k: by.get(k, 0.0) for k in (
            "flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
        total = sum(attn.values())
        log(f"[train] attention kernels: {json.dumps(attn)} ms, together "
            f"{total:.2f} ms of one profiled step, "
            f"{total / (step_s * 1e3):.3f} of the unprofiled median step, "
            f"{total / (report['device_busy_s'] * 1e3):.3f} of its device "
            f"busy time")
    del state, tokens, targets, metrics
    torch.cuda.empty_cache()
    return summary


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


def report_profile(prof, wall_s: float, out_dir: str, name: str) -> dict:
    """Where a profiled phase's device time went: kernel time by kernel
    class and the top kernels, and the share of the (profiled, so
    longer) wall time with no kernel running. The full table goes to
    out_dir/<name>_profile.txt."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_class, by_name = {}, {}
    for e in kernels:
        n = e.name
        low = n.lower()
        cls = ("flash_attn_fwd" if "fwd_bf16" in n or "fwd_f32_fma" in n
               else "flash_attn_bwd_dq" if "dq_bf16" in n
               or "dq_f32_fma" in n
               else "flash_attn_bwd_dkv" if "dkv_bf16" in n
               or "dkv_f32_fma" in n
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
    log(f"[profile] {name} " + json.dumps(report))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write(json.dumps(report, indent=1) + "\n\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=60))
    return report


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
        report_profile(prof, wall, profile_dir, "serve")
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


# One phase alone in a fresh process of one checkout, printing its summary
# after a tag: the names these use are the same in every slice of the
# port.
_PHASE_ONLY = {
    "serve": """
import json, chip_smoke
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import SOURCE, fwd_launches
_build.load(SOURCE)
print("RESULT " + json.dumps(chip_smoke.phase_serve(fwd_launches)))
""",
    "train": """
import json, chip_smoke
print("RESULT " + json.dumps(chip_smoke.phase_train()))
""",
}


def _serve_metrics(s: dict) -> dict:
    span, calls = s["device_span_s_by_path"], s["calls_by_path"]
    return {"wall_s": s["wall_s"], "ttft_p50_s": s["ttft_p50_s"],
            "decode_tok_s_per_request_p50":
                s["decode_tok_s_per_request_p50"],
            "output_tok_s": s["output_tok_s"],
            "decode_ms_per_tick": 1e3 * span["decode"] / calls["decode"],
            "decode_ticks": calls["decode"],
            "first_token_span_s": span["first_token"],
            "prefill_span_s": span["full_prefill"] + span["suffix_prefill"],
            "kernel_launches": s["kernel_launches"]}


def _train_metrics(s: dict) -> dict:
    return {"step_ms_median_2_5": 1e3 * s["step_s_median_2_5"],
            "tokens_per_s": s["tokens_per_s"], "mfu": s["mfu"],
            "peak_mem_gib": s["peak_mem_gib"], "final_loss": s["losses"][-1]}


def phase_ab(phase: str, parent: str) -> None:
    """One phase ("serve" or "train") in the checkout at `parent` and in
    this one, in turns (parent, this, this, parent, three rounds), each
    run in a fresh process on the same card: each run's metrics, then the
    median and range of each side."""
    metrics = {"serve": _serve_metrics, "train": _train_metrics}[phase]
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "change": []}
    for _ in range(3):
        for side, cwd in (("parent", parent), ("change", here),
                          ("change", here), ("parent", parent)):
            out = subprocess.run([sys.executable, "-c", _PHASE_ONLY[phase]],
                                 cwd=cwd, capture_output=True, text=True,
                                 timeout=600, check=True).stdout
            run = metrics(json.loads(next(
                line for line in out.splitlines()
                if line.startswith("RESULT "))[7:]))
            runs[side].append(run)
            log(f"[{phase}-ab] {side} " + json.dumps(run))
    for side, rs in runs.items():
        log(f"[{phase}-ab] {side} median and range over {len(rs)} runs: "
            + json.dumps({k: [float(np.median([r[k] for r in rs])),
                              min(r[k] for r in rs), max(r[k] for r in rs)]
                          for k in rs[0]}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from ray_tpu_torch.ops.flash_attention import fwd_launches

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default="",
                    help="profile one train step and the serve phase with "
                         "torch.profiler and write their breakdowns to "
                         "DIR/train_profile.txt and DIR/serve_profile.txt")
    for phase in ("serve", "train"):
        ap.add_argument(f"--{phase}-ab", metavar="PARENT", default="",
                        help=f"run only the {phase} phase, in the checkout "
                             "at PARENT and in this one in turns, and "
                             "compare")
    args = ap.parse_args()
    profile_dir = args.profile
    t_start = time.perf_counter()
    env = phase_env()
    if args.serve_ab or args.train_ab:
        phase = "serve" if args.serve_ab else "train"
        phase_ab(phase, args.serve_ab or args.train_ab)
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(env["card"])
        return 0
    phase_build()
    rows = phase_kernels()
    bwd = phase_bwd_kernels()
    phase_model()
    phase_model_grads()
    train = phase_train(profile_dir)
    serve = phase_serve(fwd_launches, profile_dir)
    fwd = rows["prefill_1024"]            # the largest bucket served
    tb = bwd["train"]                     # the training shape
    src = "ray_tpu_torch/ops/csrc/"
    ref = "ray_tpu/ops/flash_attention.py:"
    # Each path's launches were counted from 0 just before it ran: the
    # serve phase's for the forward, the train phase's for all three.
    fwd_by_path = {"serve": serve["kernel_launches"],
                   "train": train["launches"]["flash_attn_fwd"]}
    kernels = {"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": src + "flash_attn_fwd.cu", "replaces": ref + "55",
         "launches": sum(fwd_by_path.values()),
         "launches_by_path": fwd_by_path,
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["ms"],
         "ms_range": fwd["ms_range"], "plain_ms": fwd["plain_ms"],
         "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
         "library_ms": fwd["library_ms"],
         "library_ms_range": fwd["library_ms_range"],
         "train_shape": {k: rows["train"][k] for k in (
             "ms", "ms_range", "library_ms", "library_ms_range",
             "bound_ms", "tflops")}},
        {"name": "flash_attn_bwd_dq", "route": "cuda",
         "source": src + "flash_attn_bwd.cu", "replaces": ref + "168",
         "launches": train["launches"]["flash_attn_bwd_dq"],
         "max_abs_err": tb["err"]["dq"], "ms": tb["dq_ms"],
         "plain_ms": tb["plain_ms"], **tb["dq"],
         "library_ms": tb["library_ms"],
         "library_ms_range": tb["library_ms_range"]},
        {"name": "flash_attn_bwd_dkv", "route": "cuda",
         "source": src + "flash_attn_bwd.cu", "replaces": ref + "219",
         "launches": train["launches"]["flash_attn_bwd_dkv"],
         "max_abs_err": max(tb["err"]["dk"], tb["err"]["dv"]),
         "ms": tb["dkv_ms"], "plain_ms": tb["plain_ms"], **tb["dkv"],
         "library_ms": tb["library_ms"],
         "library_ms_range": tb["library_ms_range"]}]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(env["card"])
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
