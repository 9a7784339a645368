"""Rollout: a generator hosting a log-prob-capturing serving engine, the
counterpart of the JAX package's ``rlhf/rollout.py`` as a plain class.

Each ``RolloutWorker`` owns one ``LLMEngine(capture_logprobs=True)``:
continuous batching, registered-prefix KV reuse for a shared system
prompt, and per-token log-prob capture at sampling time (the GRPO ratio
term's old-policy log-probs). ``rollout()`` fans a prompt batch through
the engine and returns fixed-shape numpy buffers; ``refresh_weights()``
installs a new policy from param blocks of host arrays
(``GRPOLearner.param_blocks``), which the engine copies into its own
serving storage. ``learner_inputs()`` puts a rollout's log-probs and
completion mask on the learner's shifted axis.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .._device import DeviceLike, resolve_device
from ..models.configs import TransformerConfig
from ..models.transformer import init_params
from ..serve.llm import LLMEngine
from ..train.step import _leaves, _rebuild


class RolloutWorker:
    """Generator for the GRPO loop. Starts from a seed-initialized policy;
    the loop's first weight refresh overwrites it with the learner's, so
    generation and update run the same weights (every rollout result
    carries the policy version it sampled from)."""

    def __init__(self, cfg: TransformerConfig, *, num_slots: int = 4,
                 seed: int = 0, decode_block: int = 16,
                 system_prompt: Optional[Sequence[int]] = None,
                 device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        self.cfg = cfg
        self.engine = LLMEngine(cfg, init_params(cfg, seed, device=dev),
                                num_slots=num_slots, seed=seed,
                                decode_block=decode_block,
                                capture_logprobs=True, device=dev)
        self._version = -1  # seed weights; refresh installs version >= 0
        self._refresh_bytes = 0
        self._inject_delay_s = 0.0
        if system_prompt:
            self.engine.register_prefix(list(system_prompt))

    def inject_fault(self, kind: str, value) -> None:
        """`rollout_delay_s` makes this generator a deterministic
        straggler: every rollout sleeps first."""
        if kind == "rollout_delay_s":
            self._inject_delay_s = float(value)
        else:
            raise ValueError(f"unknown fault kind: {kind}")

    # -- weight refresh ------------------------------------------------

    def refresh_weights(self, version: int, *blocks) -> Dict[str, Any]:
        """Install policy `version` from param blocks ((leaf index, host
        array) pairs, any split, leaves in the key-sorted order of the
        parameter dictionary). The registered system prompt's KV is
        recomputed under the new weights."""
        t0 = time.perf_counter()
        pairs: List = []
        for block in blocks:
            pairs.extend(block)
        leaves = _leaves(self.engine.params)
        if len(pairs) != len(leaves):
            raise ValueError(
                f"weight refresh v{version}: got {len(pairs)} leaves, "
                f"policy has {len(leaves)}")
        by_idx = dict(pairs)
        self.engine.set_params(_rebuild(
            self.engine.params, [by_idx[i] for i in range(len(leaves))]))
        self._version = int(version)
        nbytes = sum(np.asarray(a).nbytes for _, a in pairs)
        self._refresh_bytes += nbytes
        return {"version": self._version, "bytes": nbytes,
                "seconds": time.perf_counter() - t0}

    def weight_version(self) -> int:
        return self._version

    # -- generation ----------------------------------------------------

    def rollout(self, prompts: np.ndarray, *, group_size: int = 1,
                max_new_tokens: int = 16, temperature: float = 1.0,
                eos_token: Optional[int] = None,
                seed: Optional[int] = None) -> Dict[str, Any]:
        """prompts (n, P) int -> `group_size` completions per prompt.

        Returns fixed-shape buffers (N = n * group_size, S = P +
        max_new_tokens, group-major order): "seqs" (N, S) int32 full
        sequences zero-padded past each completion, "logprobs" (N,
        max_new) sampling-time logp per generated token, "lengths" (N,)
        completion lengths, and the policy "version" sampled from.
        `seed` is accepted and unused, as by the JAX worker: the engine's
        sampler, seeded at construction, draws on."""
        if self._inject_delay_s > 0:
            time.sleep(self._inject_delay_s)
        prompts = np.asarray(prompts, np.int32)
        n, P = prompts.shape
        grouped = np.repeat(prompts, group_size, axis=0)
        N = n * group_size
        S = P + max_new_tokens

        t0 = time.perf_counter()
        reqs = [self.engine.submit(
            grouped[i].tolist(), max_new_tokens=max_new_tokens,
            temperature=temperature, eos_token=eos_token)
            for i in range(N)]
        while any(r.finish_ts == 0.0 for r in reqs):
            self.engine.step()
        gen_s = time.perf_counter() - t0

        seqs = np.zeros((N, S), np.int32)
        seqs[:, :P] = grouped
        logprobs = np.zeros((N, max_new_tokens), np.float32)
        lengths = np.zeros((N,), np.int32)
        for i, r in enumerate(reqs):
            L = len(r.tokens)
            seqs[i, P:P + L] = r.tokens
            logprobs[i, :L] = r.logprobs
            lengths[i] = L
        return {"seqs": seqs, "logprobs": logprobs, "lengths": lengths,
                "prompt_len": P, "tokens": int(lengths.sum()),
                "gen_s": gen_s, "version": self._version}

    def stats(self) -> Dict[str, Any]:
        return {"version": self._version,
                "refresh_bytes": self._refresh_bytes,
                "tokens_out": self.engine.tokens_out,
                "prefix_hits": self.engine.prefix_hits}


def learner_inputs(out: Dict[str, Any]):
    """(old_logp, comp_mask), each (N, S - 1) float32, from a rollout's
    "seqs", "logprobs", "lengths" and "prompt_len": the learner scores
    the token at position s + 1 from position s, so generated token t,
    at position P + t, has its log-prob and mask at index P + t - 1."""
    seqs, lengths, P = out["seqs"], out["lengths"], out["prompt_len"]
    N, S = seqs.shape
    T = S - P
    old_logp = np.zeros((N, S - 1), np.float32)
    comp_mask = np.zeros((N, S - 1), np.float32)
    old_logp[:, P - 1:P - 1 + T] = out["logprobs"]
    comp_mask[:, P - 1:P - 1 + T] = np.arange(T)[None, :] < lengths[:, None]
    return old_logp, comp_mask
