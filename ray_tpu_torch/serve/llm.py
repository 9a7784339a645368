"""Continuous-batching LLM inference engine, PyTorch.

The JAX package's ``LLMEngine``/``LLMServer`` with the same host API and
the same scheduling: a fixed pool of ``num_slots`` sequence slots backed
by one static KV cache (models/generate.py); admission packs waiting
prompts into fixed 8-row tiles per prompt-length bucket (full prefill, or
prefix-suffix prefill when the prompt extends a registered prefix);
queued requests get their first token from a cache-free forward while
every slot is busy; every tick dispatches one block of fused decode steps
for all slots, with a power-of-two block size that adapts to the
smallest remaining budget; and the host reads the previous block's tokens
one tick late, so the device-to-host round trip overlaps the next
block's compute.

Where the JAX engine starts ``copy_to_host_async``, this one copies into
pinned host memory with ``non_blocking=True`` and records a CUDA event
that the next tick waits on (``_HostCopy``).

The engine runs on the card unless built with ``device="cpu"``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..models.configs import TransformerConfig, require_dense
from ..models.generate import (
    KVCache,
    kept_rows,
    compute_prefix_kv,
    decode_multi,
    decode_multi_lp,
    decode_step,
    first_token_sample,
    first_token_sample_lp,
    first_token_suffix_sample,
    first_token_suffix_sample_lp,
    init_kv_cache,
    prefill_sample_batch,
    prefill_sample_batch_lp,
    prefill_suffix_batch,
    prefill_suffix_batch_lp,
    sample,
    token_logp,
)
from ..models.transformer import init_params, serving_params

log = logging.getLogger("ray_tpu_torch.serve")


def default_buckets(max_prompt_len: int) -> List[int]:
    out, b = [], 16
    while b < max_prompt_len:
        out.append(b)
        b *= 2
    out.append(max_prompt_len)
    return out


class _HostCopy:
    """A device-to-host copy started now and read later: into pinned
    memory with a CUDA event on the card, a plain copy on the CPU."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()
            self.event = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclass
class GenRequest:
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_token: Optional[int] = None
    # filled by the engine
    id: int = 0
    submit_ts: float = 0.0
    # First time engine compute touched the request (slot admission or
    # the queue-side early-first-token pass): splits TTFT into queue_s
    # (submit->admit) and prefill_s (admit->first token).
    admit_ts: float = 0.0
    first_token_ts: float = 0.0
    finish_ts: float = 0.0
    stream: "queue.Queue" = field(default_factory=queue.Queue)
    tokens: List[int] = field(default_factory=list)
    # log pi(tok) per emitted token, filled only on engines built with
    # capture_logprobs=True; index-aligned with `tokens`.
    logprobs: List[float] = field(default_factory=list)
    error: Optional[str] = None
    _done: bool = field(default=False, repr=False)
    # First token served queue-side before any slot freed (_admit resumes
    # decode from it).
    _early_tok: Optional[int] = field(default=None, repr=False)

    @property
    def ttft_s(self) -> float:
        return self.first_token_ts - self.submit_ts

    @property
    def latency_s(self) -> float:
        return self.finish_ts - self.submit_ts

    @property
    def queue_s(self) -> float:
        """Admission-queue wait (0.0 until admitted)."""
        if self.admit_ts == 0.0:
            return 0.0
        return self.admit_ts - self.submit_ts

    @property
    def prefill_s(self) -> float:
        """Admission -> first token (0.0 until the first token)."""
        if self.admit_ts == 0.0 or self.first_token_ts == 0.0:
            return 0.0
        return self.first_token_ts - self.admit_ts

    @property
    def decode_s(self) -> float:
        """First token -> finish (0.0 until finished)."""
        if self.first_token_ts == 0.0 or self.finish_ts == 0.0:
            return 0.0
        return self.finish_ts - self.first_token_ts

    def __iter__(self) -> Iterator[int]:
        if self._done:
            if self.error is not None:
                raise RuntimeError(f"generation failed: {self.error}")
            yield from list(self.tokens)
            return
        while True:
            tok = self.stream.get()
            if tok is None:
                self._done = True
                if self.error is not None:
                    raise RuntimeError(f"generation failed: {self.error}")
                return
            yield tok

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """ALL generated tokens, however many were already streamed —
        idempotent and safe after __iter__."""
        if self._done:
            if self.error is not None:
                raise RuntimeError(f"generation failed: {self.error}")
            return list(self.tokens)
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while True:
            left = (max(0.0, deadline - time.monotonic())
                    if deadline is not None else None)
            tok = self.stream.get(timeout=left)
            if tok is None:
                self._done = True
                if self.error is not None:
                    raise RuntimeError(f"generation failed: {self.error}")
                return list(self.tokens)


class _Slot:
    __slots__ = ("req", "emitted", "length", "inflight")

    def __init__(self, req: GenRequest, prompt_len: int):
        self.req = req
        self.emitted = 0
        self.length = prompt_len  # tokens in cache (grows per tick)
        # Decode ticks dispatched but not yet processed on the host; the
        # device-side cache position of this slot is length + inflight.
        self.inflight = 0


class LLMEngine:
    """Host-side continuous-batching loop over the prefill/decode steps.
    Thread-safe submit; `step()` is driven by `run_forever()` (background
    thread) or manually (tests).

    The engine serves its own copy of the weights it is given, in the
    serving storage (transformer.serving_params), at construction and at
    `set_params` alike: a caller that goes on updating its tensors in
    place, as a learner does its master weights, does not change the
    policy served."""

    _ADMIT_TILE = 8  # fixed batch tile of every admission dispatch

    def __init__(self, cfg: TransformerConfig, params: Any, *,
                 num_slots: int = 4, max_seq_len: Optional[int] = None,
                 top_k: int = 0, seed: int = 0, decode_block: int = 64,
                 auto_prefix_min_hits: int = 0,
                 auto_prefix_lens: Sequence[int] = (64, 128, 256, 512),
                 capture_logprobs: bool = False,
                 device: DeviceLike = "cuda"):
        require_dense(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.top_k = top_k
        self.capture_logprobs = bool(capture_logprobs)
        self.params = serving_params(cfg, params, self.device)
        # Upper bound on ticks fused per decode dispatch; the block size
        # adapts each step to the smallest remaining budget.
        self.decode_block = max(1, decode_block)
        self.cache: KVCache = init_kv_cache(cfg, num_slots, self.max_seq_len,
                                            device=self.device)
        self.cur_tokens = torch.zeros((num_slots,), dtype=torch.long,
                                      device=self.device)
        # Per-slot temperatures stay on the device, set at admission.
        self._temps = torch.zeros((num_slots,), dtype=torch.float32,
                                  device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        # One decode block pipelined: dispatched last tick, its tokens
        # read and emitted this tick.
        self._pending = None
        self.waiting: deque = deque()
        self.lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._next_id = 0
        self.buckets = default_buckets(self.max_seq_len)
        # Registered prompt prefixes: token tuple -> {"k", "v"} device KV.
        self._prefixes: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
        self.max_cached_prefixes = 8
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        # Automatic capture: block-length prompt prefixes seen
        # auto_prefix_min_hits times register on a later tick. 0 = off.
        self.auto_prefix_min_hits = int(auto_prefix_min_hits)
        self.auto_prefix_lens = tuple(sorted(auto_prefix_lens))
        self._auto_counts: "OrderedDict[tuple, int]" = OrderedDict()
        self._auto_pending: deque = deque()
        self._auto_inflight: set = set()
        self.prefix_register_failures = 0
        self.decode_ticks = 0
        self.tokens_out = 0
        self.finished: List[Dict[str, float]] = []
        self._ttft_ewma: Optional[float] = None

    # -- submission ---------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 64,
               temperature: float = 0.0,
               eos_token: Optional[int] = None) -> GenRequest:
        if self._stop:
            raise RuntimeError("engine is stopped")
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_seq_len:
            raise ValueError(
                f"prompt len {len(prompt)} >= max_seq_len {self.max_seq_len}")
        req = GenRequest(prompt=[int(t) for t in prompt],
                         max_new_tokens=max_new_tokens,
                         temperature=temperature, eos_token=eos_token)
        with self.lock:
            req.id = self._next_id
            self._next_id += 1
        req.submit_ts = time.monotonic()
        if self.auto_prefix_min_hits > 0:
            self._note_prefix_candidates(prompt)
        with self.lock:
            self.waiting.append(req)
        self._work.set()
        return req

    def generate(self, prompt: Sequence[int], *,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 eos_token: Optional[int] = None,
                 return_logprobs: bool = False,
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        """Synchronous generation: submit + wait for completion. Without
        a running background loop the engine is driven from this
        thread."""
        if return_logprobs and not self.capture_logprobs:
            raise ValueError(
                "return_logprobs=True requires "
                "LLMEngine(..., capture_logprobs=True) — the engine "
                "only records per-token logps when built to")
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature, eos_token=eos_token)
        loop = getattr(self, "_loop_thread", None)
        if loop is None or not loop.is_alive():
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while req.finish_ts == 0.0:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("generate timed out")
                self.step()
        tokens = req.result(timeout=timeout)
        out: Dict[str, Any] = {"tokens": tokens, "ttft_s": req.ttft_s,
                               "latency_s": req.latency_s,
                               "queue_s": req.queue_s,
                               "prefill_s": req.prefill_s,
                               "decode_s": req.decode_s}
        if return_logprobs:
            out["logprobs"] = list(req.logprobs)
        return out

    def _note_prefix_candidates(self, prompt: Sequence[int]) -> None:
        """Count every applicable block-length prefix beyond what a
        registered prefix already covers; hot keys enqueue for
        engine-side registration. Bounded table (LRU, 512)."""
        tokens = [int(t) for t in prompt]
        with self.lock:
            covered = 0
            for reg in self._prefixes:
                if (len(reg) > covered and len(reg) < len(tokens)
                        and tokens[:len(reg)] == list(reg)):
                    covered = len(reg)
            for L in self.auto_prefix_lens:
                if L >= len(tokens) or L >= self.max_seq_len - 1:
                    break
                if L <= covered:
                    continue
                key = tuple(tokens[:L])
                if key in self._prefixes or key in self._auto_inflight:
                    continue
                n = self._auto_counts.get(key, 0) + 1
                self._auto_counts[key] = n
                self._auto_counts.move_to_end(key)
                if n >= self.auto_prefix_min_hits:
                    del self._auto_counts[key]
                    self._auto_inflight.add(key)
                    self._auto_pending.append(key)
            while len(self._auto_counts) > 512:
                self._auto_counts.popitem(last=False)

    def _drain_auto_registrations(self) -> bool:
        """Register ONE pending hot prefix per tick, longest first; a
        pending key that prefixes an already-registered one is dropped."""
        with self.lock:
            while self._auto_pending:
                key = max(self._auto_pending, key=len)
                self._auto_pending.remove(key)
                if any(len(reg) >= len(key) and reg[:len(key)] == key
                       for reg in self._prefixes):
                    self._auto_inflight.discard(key)
                    continue
                break
            else:
                return False
        try:
            self.register_prefix(key)
        except ValueError:
            pass  # the prompt family no longer fits max_seq_len
        except Exception:  # noqa: BLE001 — device failure: drop, count, log
            self.prefix_register_failures += 1
            log.warning("auto prefix registration failed (len %d); "
                        "dropping", len(key), exc_info=True)
        finally:
            with self.lock:
                self._auto_inflight.discard(key)
        return True

    def set_params(self, params: Any) -> None:
        """Swap in new weights, then recompute every registered prefix
        (their KV was built under the old weights). Installed as in the
        constructor: the engine's own copy of each leaf in the serving
        storage."""
        params = serving_params(self.cfg, params, self.device)
        with self.lock:
            self.params = params
            keys = list(self._prefixes)
            self._prefixes.clear()
        for key in keys:
            self.register_prefix(key)

    def register_prefix(self, tokens: Sequence[int]) -> None:
        """Precompute and pin the KV of a shared prompt prefix; later
        prompts starting with it skip its prefill. LRU-capped at
        max_cached_prefixes."""
        key = tuple(int(t) for t in tokens)
        if not key:
            raise ValueError("empty prefix")
        if len(key) >= self.max_seq_len - 1:
            raise ValueError(
                f"prefix len {len(key)} leaves no room for a suffix "
                f"(max_seq_len {self.max_seq_len})")
        with self.lock:
            if key in self._prefixes:
                self._prefixes.move_to_end(key)
                return
        pk, pv = compute_prefix_kv(self.cfg, self.params, key)
        with self.lock:
            self._prefixes[key] = {"k": pk, "v": pv}
            while len(self._prefixes) > self.max_cached_prefixes:
                self._prefixes.popitem(last=False)

    def _match_prefix(self, prompt: List[int]):
        """Longest registered prefix that strictly prefixes `prompt` and
        whose install still fits the cache after suffix-bucket rounding.
        Returns (key, entry) or None."""
        if not self._prefixes:
            return None
        with self.lock:
            cands = sorted(self._prefixes, key=len, reverse=True)
        for key in cands:
            sp = len(key)
            if len(prompt) <= sp or tuple(prompt[:sp]) != key:
                continue
            if sp + self._bucket_for(len(prompt) - sp) > self.max_seq_len:
                continue
            with self.lock:
                entry = self._prefixes.get(key)
                if entry is not None:
                    self._prefixes.move_to_end(key)
                    return key, entry
        return None

    def _group_by_route(self, items: List, prompt_of):
        """Split items into full-prefill tiles and prefix-suffix tiles
        (fixed W rows each): (full [(bucket, chunk)], suffix [(pkey,
        entry, bucket, chunk)]) — one implementation for admission and
        early first tokens."""
        by_bucket: Dict[int, List] = {}
        by_prefix: Dict[tuple, List] = {}
        entries: Dict[tuple, Dict[str, Any]] = {}
        for it in items:
            prompt = prompt_of(it)
            match = self._match_prefix(prompt)
            if match is not None:
                pkey, entry = match
                entries[pkey] = entry
                by_prefix.setdefault(pkey, []).append(it)
            else:
                by_bucket.setdefault(
                    self._bucket_for(len(prompt)), []).append(it)
        W = self._ADMIT_TILE
        full = [(b, p[off:off + W])
                for b, p in sorted(by_bucket.items())
                for off in range(0, len(p), W)]
        suffix = []
        for pkey, its in by_prefix.items():
            sub: Dict[int, List] = {}
            for it in its:
                sub.setdefault(
                    self._bucket_for(len(prompt_of(it)) - len(pkey)),
                    []).append(it)
            for b, p in sorted(sub.items()):
                for off in range(0, len(p), W):
                    suffix.append((pkey, entries[pkey], b, p[off:off + W]))
        return full, suffix

    # -- engine internals ---------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _emit(self, slot: _Slot, tok: int,
              lp: Optional[float] = None) -> None:
        slot.req.tokens.append(tok)
        if lp is not None:
            slot.req.logprobs.append(float(lp))
        slot.req.stream.put(tok)
        slot.emitted += 1
        slot.length += 1
        self.tokens_out += 1

    def _complete(self, req: GenRequest, new_tokens: int) -> None:
        """Request-completion bookkeeping (slot and queue-side finishes)."""
        req.finish_ts = time.monotonic()
        req.stream.put(None)
        self.finished.append({
            "id": req.id,
            "ttft_s": req.ttft_s,
            "latency_s": req.latency_s,
            "queue_s": req.queue_s,
            "prefill_s": req.prefill_s,
            "decode_s": req.decode_s,
            "new_tokens": new_tokens,
        })
        self._ttft_ewma = (
            req.ttft_s if self._ttft_ewma is None
            else 0.8 * self._ttft_ewma + 0.2 * req.ttft_s)

    def _finish(self, idx: int) -> None:
        slot = self.slots[idx]
        self._complete(slot.req, slot.emitted)
        self.slots[idx] = None

    def _build_tile(self, bucket: int, rows: Sequence):
        """Pad up to _ADMIT_TILE token lists into one (W, bucket) tile on
        the host, then move it, its lengths and temps to the device in
        one transfer each. rows: [(tokens, temperature)]."""
        W = self._ADMIT_TILE
        buf = np.zeros((W, bucket), np.int64)
        lens = np.ones((W,), np.int64)
        temps = np.zeros((W,), np.float32)
        for j, (tokens, temp) in enumerate(rows):
            n = len(tokens)
            buf[j, :n] = np.asarray(tokens, np.int64)
            lens[j] = n
            temps[j] = temp
        dev = self.device
        return (torch.from_numpy(buf).to(dev), torch.from_numpy(lens).to(dev),
                torch.from_numpy(temps).to(dev))

    def _set_rows(self, dst: torch.Tensor, slot_idx: np.ndarray,
                  values: torch.Tensor) -> None:
        """dst[slot_idx[j]] = values[j] for in-range slots (padding rows
        carry slot == num_slots and are dropped)."""
        rows, kept = kept_rows(slot_idx, len(dst), dst.device)
        dst[kept] = values[rows].to(dst.dtype)

    def _admit(self) -> List:
        """Prefill waiting requests into free slots (arrival order),
        batched per prompt-length bucket into fixed W-row tiles. Requests
        whose first token was already served queue-side are prefilled in
        the same batch and resume from the token the client saw. Returns
        [(idx, tok_dev, lp_dev | None)]."""
        with self.lock:
            free = [i for i, s in enumerate(self.slots) if s is None]
            take: List = []
            while free[len(take):] and self.waiting:
                take.append(self.waiting.popleft())
        if not take:
            return []
        now = time.monotonic()
        for req in take:
            if req.admit_ts == 0.0:
                req.admit_ts = now

        admitted: List = []
        W = self._ADMIT_TILE
        full, suffix = self._group_by_route(
            list(zip(take, free)), lambda it: it[0].prompt)
        chunks: List = [("full", bucket, None, chunk)
                        for bucket, chunk in full]
        chunks += [("suffix", (pkey, bucket), entry, chunk)
                   for pkey, entry, bucket, chunk in suffix]

        for ci, (kind, binfo, entry, chunk) in enumerate(chunks):
            slot_idx = np.full((W,), self.num_slots, np.int64)
            for j, (_, idx) in enumerate(chunk):
                slot_idx[j] = idx
            lps = None
            try:
                if kind == "full":
                    buf, lens, temps = self._build_tile(
                        binfo, [(req.prompt, req.temperature)
                                for req, _ in chunk])
                    args = (self.cfg, self.params, self.cache, buf, lens,
                            slot_idx, self.top_k, temps, self._gen)
                    if self.capture_logprobs:
                        self.cache, toks, lps = prefill_sample_batch_lp(*args)
                    else:
                        self.cache, toks = prefill_sample_batch(*args)
                else:
                    pkey, bucket = binfo
                    sp = len(pkey)
                    buf, lens, temps = self._build_tile(
                        bucket, [(req.prompt[sp:], req.temperature)
                                 for req, _ in chunk])
                    args = (self.cfg, self.params, self.cache, entry["k"],
                            entry["v"], buf, lens, slot_idx, self.top_k,
                            temps, self._gen)
                    if self.capture_logprobs:
                        self.cache, toks, lps = \
                            prefill_suffix_batch_lp(*args)
                    else:
                        self.cache, toks = prefill_suffix_batch(*args)
                    self.prefix_hits += len(chunk)
                    self.prefix_tokens_saved += sp * len(chunk)
            except Exception:
                # Put this and every unprocessed request back so
                # _fail_all can notify their clients.
                with self.lock:
                    for _, _, _, later in reversed(chunks[ci:]):
                        for req, _ in reversed(later):
                            self.waiting.appendleft(req)
                raise
            self._set_rows(self._temps, slot_idx, temps)
            self._set_rows(self.cur_tokens, slot_idx, toks)
            for j, (req, idx) in enumerate(chunk):
                slot = _Slot(req, len(req.prompt))
                self.slots[idx] = slot
                if req._early_tok is not None:
                    # First token already delivered queue-side: decode
                    # continues from the token the client saw.
                    slot.emitted = len(req.tokens)
                    slot.length = len(req.prompt) + slot.emitted
                    self.cur_tokens[idx] = int(req._early_tok)
                else:
                    admitted.append(
                        (idx, toks[j], lps[j] if lps is not None else None))
        return admitted

    def _early_first_tokens(self) -> List:
        """Queued requests that could not be admitted get their FIRST
        token from a cache-free batched forward, one dispatch per tile.
        Returns [(chunk_requests, toks_dev, lps_dev | None)]."""
        with self.lock:
            todo = [r for r in self.waiting if r.first_token_ts == 0.0]
        if not todo:
            return []
        now = time.monotonic()
        for r in todo:
            if r.admit_ts == 0.0:
                r.admit_ts = now
        outs = []
        full, suffix = self._group_by_route(todo, lambda r: r.prompt)
        for bucket, chunk in full:
            buf, lens, temps = self._build_tile(
                bucket, [(r.prompt, r.temperature) for r in chunk])
            args = (self.cfg, self.params, buf, lens, temps, self.top_k,
                    self._gen)
            if self.capture_logprobs:
                toks, lps = first_token_sample_lp(*args)
            else:
                toks, lps = first_token_sample(*args), None
            outs.append((chunk, toks, lps))
        for pkey, entry, bucket, chunk in suffix:
            sp = len(pkey)
            buf, lens, temps = self._build_tile(
                bucket, [(r.prompt[sp:], r.temperature) for r in chunk])
            args = (self.cfg, self.params, entry["k"], entry["v"], buf,
                    lens, temps, self.top_k, self._gen)
            if self.capture_logprobs:
                toks, lps = first_token_suffix_sample_lp(*args)
            else:
                toks, lps = first_token_suffix_sample(*args), None
            self.prefix_hits += len(chunk)
            self.prefix_tokens_saved += sp * len(chunk)
            outs.append((chunk, toks, lps))
        return outs

    def _fuse_first_tokens(self, admitted: List, outs: List):
        """Concatenate every pending first token into ONE device tensor and
        start its host copy, enqueued BEFORE the decode block so the copy
        does not wait out the block."""
        if not admitted and not outs:
            return None
        parts = []
        if admitted:
            parts.append(torch.stack([t for _, t, _ in admitted]))
        parts += [t[:len(reqs)] for reqs, t, _ in outs]
        fused = _HostCopy(torch.cat(parts))
        fused_lp = None
        if self.capture_logprobs:
            lp_parts = []
            if admitted:
                lp_parts.append(torch.stack([l for _, _, l in admitted]))
            lp_parts += [l[:len(reqs)] for reqs, _, l in outs]
            fused_lp = _HostCopy(torch.cat(lp_parts))
        return fused, fused_lp

    def _deliver_first_tokens(self, fused_pair, admitted: List,
                              outs: List) -> None:
        """Emit the fused first tokens (one host wait, usually already
        complete)."""
        if fused_pair is None:
            return
        fused, fused_lp = fused_pair
        fused = fused.numpy()
        fused_lp = fused_lp.numpy() if fused_lp is not None else None
        pos = 0
        now = time.monotonic()
        for j, ((idx, _, _), tok) in enumerate(
                zip(admitted, fused[:len(admitted)])):
            slot = self.slots[idx]
            if slot is None:  # drained by a concurrent stop()
                continue
            tok = int(tok)
            slot.req.first_token_ts = now
            self._emit(slot, tok,
                       fused_lp[j] if fused_lp is not None else None)
            if (tok == slot.req.eos_token
                    or slot.emitted >= slot.req.max_new_tokens):
                self._finish(idx)
        pos = len(admitted)
        for reqs, _, _ in outs:
            host = fused[pos:pos + len(reqs)]
            host_lp = (fused_lp[pos:pos + len(reqs)]
                       if fused_lp is not None else None)
            pos += len(reqs)
            for j, r in enumerate(reqs):
                tok = int(host[j])
                r.first_token_ts = now
                r._early_tok = tok
                r.tokens.append(tok)
                if host_lp is not None:
                    r.logprobs.append(float(host_lp[j]))
                r.stream.put(tok)
                self.tokens_out += 1
                if tok == r.eos_token or r.max_new_tokens <= 1:
                    # Finished before ever occupying a slot.
                    with self.lock:
                        try:
                            self.waiting.remove(r)
                        except ValueError:
                            continue  # already admitted concurrently
                    self._complete(r, len(r.tokens))

    @torch.no_grad()
    def step(self) -> bool:
        """One engine tick: admit, serve queued requests' first tokens,
        dispatch one fused block of decode steps for all slots, then
        process the PREVIOUS tick's block (its host copy overlapped this
        block's compute). Returns False when idle."""
        registered = (self._drain_auto_registrations()
                      if self.auto_prefix_min_hits > 0 else False)
        admitted = self._admit()
        outs = self._early_first_tokens()
        fused = self._fuse_first_tokens(admitted, outs)
        # Snapshot: a concurrent stop()/_fail_all may None-out entries.
        snap = list(self.slots)
        active = [i for i, s in enumerate(snap) if s is not None]
        block = None
        if active:
            # Block size: the smallest remaining budget among active
            # slots (counting ticks in flight) rounded UP to a power of
            # two, capped by decode_block and by every slot's device-side
            # cache headroom.
            headroom = min(self.max_seq_len - 1
                           - snap[i].length - snap[i].inflight
                           for i in active)
            budget = max(snap[i].req.max_new_tokens - snap[i].emitted
                         - snap[i].inflight for i in active)
            if budget > 0 or self._pending is None:
                remaining = max(1, min(
                    max(1, snap[i].req.max_new_tokens - snap[i].emitted
                        - snap[i].inflight) for i in active))
                k_block = 1
                while k_block < remaining:
                    k_block *= 2
                k_block = min(k_block, self.decode_block, max(1, headroom))
                while k_block & (k_block - 1):
                    k_block &= k_block - 1

                lps = None
                if k_block == 1:
                    self.cache, logits = decode_step(
                        self.cfg, self.params, self.cache, self.cur_tokens)
                    toks = sample(logits, self._gen,
                                  temperature=self._temps,
                                  top_k=self.top_k)[None]         # (1, B)
                    if self.capture_logprobs:
                        lps = token_logp(logits, toks[0])[None]
                elif self.capture_logprobs:
                    self.cache, toks, lps = decode_multi_lp(
                        self.cfg, self.params, self.cache, self.cur_tokens,
                        self._temps, k_block, self.top_k, self._gen)
                else:
                    self.cache, toks = decode_multi(
                        self.cfg, self.params, self.cache, self.cur_tokens,
                        self._temps, k_block, self.top_k, self._gen)
                self.cur_tokens = toks[-1].clone()
                # Start the host copies now, before the next tick enqueues
                # more work.
                host = (_HostCopy(toks),
                        _HostCopy(lps) if lps is not None else None)
                self.decode_ticks += k_block
                for i in active:
                    snap[i].inflight += k_block
                block = (host, k_block, [(i, snap[i]) for i in active])
            # else: every active budget is covered by the block in flight.

        self._deliver_first_tokens(fused, admitted, outs)
        prev, self._pending = self._pending, block
        if prev is not None:
            self._process_block(prev)
        return bool(admitted or outs or block or prev or registered)

    def _process_block(self, block) -> None:
        """Read a dispatched decode block's tokens and emit them. The
        snapshot carries the _Slot OBJECTS of dispatch time, so a slot
        freed and readmitted meanwhile never receives the dead request's
        overshoot tokens."""
        (toks, lps), k_block, slot_snap = block
        host_toks = toks.numpy()
        host_lps = lps.numpy() if lps is not None else None
        for i, slot0 in slot_snap:
            slot0.inflight -= k_block
            slot = self.slots[i]
            if slot is not slot0:
                continue
            for t in range(k_block):
                if slot is None or slot is not slot0:
                    break
                tok = int(host_toks[t, i])
                self._emit(slot, tok,
                           host_lps[t, i] if host_lps is not None else None)
                done = (tok == slot.req.eos_token
                        or slot.emitted >= slot.req.max_new_tokens
                        or slot.length >= self.max_seq_len - 1)
                if done:
                    self._finish(i)
                    break
                slot = self.slots[i]

    def run_forever(self) -> None:
        while not self._stop:
            try:
                busy = self.step()
            except Exception as e:  # noqa: BLE001 — unblock every client
                self._fail_all(e)
                raise
            if not busy:
                self._work.clear()
                self._work.wait(timeout=0.1)

    def _fail_all(self, exc: Exception) -> None:
        """A step blew up: unblock every waiting client with the error
        instead of hanging their streams forever."""
        self._stop = True
        msg = f"{type(exc).__name__}: {exc}"
        with self.lock:
            pending = list(self.waiting)
            self.waiting.clear()
        for i, slot in enumerate(self.slots):
            if slot is not None:
                slot.req.error = msg
                slot.req.finish_ts = time.monotonic()
                slot.req.stream.put(None)
                self.slots[i] = None
        for req in pending:
            req.error = msg
            req.finish_ts = time.monotonic()
            req.stream.put(None)

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.run_forever, daemon=True,
                             name="llm-engine")
        self._loop_thread = t
        t.start()
        return t

    def stop(self) -> None:
        """Stop the engine; every in-flight or waiting client gets an
        'engine stopped' error instead of hanging on its stream."""
        self._stop = True
        self._work.set()
        self._fail_all(RuntimeError("engine stopped"))
        loop = getattr(self, "_loop_thread", None)
        if loop is not None and loop is not threading.current_thread():
            loop.join(timeout=60)  # the step in flight finishes first

    def stats(self) -> Dict[str, Any]:
        fin = self.finished
        ttfts = sorted(f["ttft_s"] for f in fin)
        out: Dict[str, Any] = {
            "finished": len(fin),
            "decode_ticks": self.decode_ticks,
            "tokens_out": self.tokens_out,
            "waiting": len(self.waiting),
            "active": sum(s is not None for s in self.slots),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "cached_prefixes": len(self._prefixes),
        }
        if ttfts:
            out["ttft_p50_s"] = ttfts[len(ttfts) // 2]
            out["ttft_p99_s"] = ttfts[min(len(ttfts) - 1,
                                          int(len(ttfts) * 0.99))]
        if self._ttft_ewma is not None:
            out["ewma_ttft_s"] = self._ttft_ewma
        return out

    def serve_routing_stats(self) -> Dict[str, Any]:
        """Routing signals (queue depth, TTFT EWMA) for a replica router."""
        out: Dict[str, Any] = {"engine_queue": len(self.waiting)}
        if self._ttft_ewma is not None:
            out["ewma_ttft_s"] = self._ttft_ewma
        return out


class LLMServer:
    """One engine on a background loop: the replica-side object a serve
    deployment wraps. Weights are drawn from `seed` when not given."""

    def __init__(self, cfg: TransformerConfig, params: Any = None, *,
                 num_slots: int = 4, max_seq_len: Optional[int] = None,
                 seed: int = 0, auto_prefix_min_hits: int = 0,
                 auto_prefix_lens: Sequence[int] = (64, 128, 256, 512),
                 capture_logprobs: bool = False,
                 device: DeviceLike = "cuda"):
        device = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, device=device)
        self.engine = LLMEngine(cfg, params, num_slots=num_slots,
                                max_seq_len=max_seq_len, seed=seed,
                                auto_prefix_min_hits=auto_prefix_min_hits,
                                auto_prefix_lens=auto_prefix_lens,
                                capture_logprobs=capture_logprobs,
                                device=device)
        self.engine.start()

    def generate(self, prompt: Sequence[int], *, max_new_tokens: int = 64,
                 temperature: float = 0.0,
                 eos_token: Optional[int] = None,
                 return_logprobs: bool = False) -> Dict[str, Any]:
        return self.engine.generate(
            prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, eos_token=eos_token,
            return_logprobs=return_logprobs)

    def register_prefix(self, tokens: Sequence[int]) -> None:
        """Precompute a shared prompt prefix's KV on this replica."""
        self.engine.register_prefix(tokens)

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def serve_routing_stats(self) -> Dict[str, Any]:
        return self.engine.serve_routing_stats()

    def stop(self) -> None:
        """Stop the engine loop and fail any request still in flight."""
        self.engine.stop()
