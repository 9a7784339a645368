"""GRPO learner on one device: the counterpart of the JAX package's
``rlhf/learner.py`` without a ``ParallelPlan``.

``make_grpo_step`` is ``train.step.make_train_step`` with the GRPO loss:
advantages are normalised inside the step from the raw rewards (group
mean and population std, as ``jnp.std``), the ratio against the sampling
policy's log-probs is clipped, and a k3 KL estimate against that policy
is added. The old-policy log-probs come from the serving engine's
sampling-time capture (``LLMEngine(capture_logprobs=True)``), never from
a second forward.

``GRPOLearner`` holds a ``TrainState`` (f32 master weights, AdamW
moments) and publishes its policy as byte-balanced blocks of host arrays
(``param_blocks``), the form ``RolloutWorker.refresh_weights`` installs.
The update runs in place on the masters (see ``train/step.py``), so a
policy is handed to an engine only as such a copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..convert import params_from_numpy
from ..models.configs import TransformerConfig
from ..models.transformer import Metrics, forward
from ..train.step import (
    AdamWState,
    Optimizer,
    TrainState,
    _leaves,
    _rebuild,
    init_state,
    make_optimizer,
    make_train_step,
)


@dataclass(frozen=True)
class GRPOLearnerConfig:
    model: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(
            vocab_size=128, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=4, d_ff=128, max_seq_len=64,
            dtype=torch.float32, param_dtype=torch.float32, remat=False))
    group_size: int = 4
    clip_eps: float = 0.2
    kl_coef: float = 0.02
    lr: float = 1e-4
    warmup_steps: int = 5
    total_steps: int = 1000
    grad_clip: float = 1.0
    weight_decay: float = 0.0
    seed: int = 0


def sequence_logp(cfg: TransformerConfig, params, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """log pi(tokens[:, 1:]) under `params`: log_softmax in f32 of the
    logits at positions 0..S-2, gathered at the next token. (N, S) ->
    (N, S-1) f32."""
    logits, _ = forward(cfg, params, tokens)
    lp_all = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return lp_all.gather(-1, tokens[:, 1:, None].long())[..., 0]


def make_grpo_step(cfg: GRPOLearnerConfig, optimizer: Optimizer):
    """-> step(state, tokens, old_logp, rewards, comp_mask) -> (state,
    metrics): one GRPO update on the device the params live on, in place
    as make_train_step's. Metrics (0-d tensors): loss, pg_loss, kl,
    reward_mean and grad_norm (the global norm of the raw grads)."""
    mcfg, G = cfg.model, cfg.group_size

    def _loss(params, tokens, batch: Tuple[torch.Tensor, torch.Tensor],
              comp_mask) -> Tuple[torch.Tensor, Metrics]:
        old_logp, advantages = batch
        lp = sequence_logp(mcfg, params, tokens)
        ratio = torch.exp(lp - old_logp)
        adv = advantages[:, None]
        clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
        pg = torch.minimum(ratio * adv, clipped * adv)
        # k3 KL estimator against the sampling policy.
        log_r = old_logp - lp
        kl = torch.exp(log_r) - log_r - 1.0
        denom = torch.clamp(comp_mask.sum(), min=1.0)
        loss = (-(pg - cfg.kl_coef * kl) * comp_mask).sum() / denom
        return loss, {"loss": loss,
                      "pg_loss": -(pg * comp_mask).sum() / denom,
                      "kl": (kl * comp_mask).sum() / denom}

    train_step = make_train_step(mcfg, optimizer, loss=_loss)

    def grpo_step(state: TrainState, tokens, old_logp, rewards, comp_mask
                  ) -> Tuple[TrainState, Metrics]:
        groups = rewards.reshape(-1, G)
        mean = groups.mean(dim=1, keepdim=True)
        # Population std (jnp.std), not torch's default unbiased one.
        std = groups.std(dim=1, keepdim=True, correction=0) + 1e-6
        advantages = ((groups - mean) / std).reshape(-1)
        state, metrics = train_step(state, tokens, (old_logp, advantages),
                                    comp_mask)
        metrics["reward_mean"] = rewards.mean()
        return state, metrics

    return grpo_step


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` (never a view of it: on the CPU the learner's
    tensors are updated in place)."""
    return t.detach().to("cpu", copy=True).numpy()


class GRPOLearner:
    """GRPO update on one device. `update()` takes one rollout batch
    (host numpy) and returns host floats; `param_blocks()` publishes the
    current policy as host arrays for the weight refresh; get_state /
    set_state round-trip through host arrays."""

    def __init__(self, cfg: GRPOLearnerConfig, *,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(
            cfg.lr, warmup_steps=cfg.warmup_steps,
            total_steps=cfg.total_steps, weight_decay=cfg.weight_decay,
            grad_clip=cfg.grad_clip)
        self.state = init_state(cfg.model, self.optimizer, seed=cfg.seed,
                                device=self.device)
        self._step = make_grpo_step(cfg, self.optimizer)

    @property
    def step_count(self) -> int:
        return self.state.step

    # -- update -------------------------------------------------------

    def _place(self, arr, dtype) -> torch.Tensor:
        """A copy of host `arr` on the learner's device (never a view:
        on the CPU the moments are updated in place)."""
        return torch.tensor(np.asarray(arr), dtype=dtype, device=self.device)

    def update(self, tokens: np.ndarray, old_logp: np.ndarray,
               rewards: np.ndarray,
               comp_mask: np.ndarray) -> Dict[str, float]:
        """One GRPO update from a rollout batch.

        tokens (N, S) int full sequences (prompt + completion); old_logp
        (N, S-1) f32 sampling-time logp of tokens[:, 1:] (zeros where
        comp_mask is zero); rewards (N,) raw sequence rewards, N =
        num_groups * group_size ordered group-major; comp_mask (N, S-1)
        f32 completion mask over the shifted axis."""
        N = tokens.shape[0]
        if N % self.cfg.group_size:
            raise ValueError(
                f"batch of {N} sequences is not a multiple of "
                f"group_size={self.cfg.group_size}")
        self.state, metrics = self._step(
            self.state, self._place(tokens, torch.long),
            self._place(old_logp, torch.float32),
            self._place(rewards, torch.float32),
            self._place(comp_mask, torch.float32))
        names = sorted(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        return dict(zip(names, values))

    # -- weight publication -------------------------------------------

    def param_blocks(self, num_blocks: int = 8
                     ) -> List[List[Tuple[int, np.ndarray]]]:
        """The current policy as `num_blocks` contiguous, byte-balanced
        blocks of (leaf index, host array) pairs, leaves in the key-sorted
        order of jax.tree.leaves. Every array is a copy."""
        host = [_host(t) for t in _leaves(self.state.params)]
        sizes = [x.nbytes for x in host]
        total = max(sum(sizes), 1)
        num_blocks = max(1, min(num_blocks, len(host)))
        per_block = total / num_blocks
        blocks, cur, acc = [], [], 0
        for i, x in enumerate(host):
            cur.append((i, x))
            acc += sizes[i]
            if acc >= per_block * (len(blocks) + 1) \
                    and len(blocks) < num_blocks - 1:
                blocks.append(cur)
                cur = []
        if cur:
            blocks.append(cur)
        return blocks

    def params_host(self) -> Dict[str, Any]:
        """The policy as a nested dict of host arrays."""
        params = self.state.params
        return _rebuild(params, [_host(t) for t in _leaves(params)])

    # -- state round-trip ---------------------------------------------

    def get_state(self) -> Dict[str, Any]:
        """{"step": int, "params": params_host(), "opt_state":
        AdamWState(count, mu, nu) with host arrays in leaf order}."""
        opt = self.state.opt_state
        return {"step": int(self.state.step), "params": self.params_host(),
                "opt_state": AdamWState(int(opt.count),
                                        [_host(m) for m in opt.mu],
                                        [_host(v) for v in opt.nu])}

    def set_state(self, state: Dict[str, Any]) -> None:
        """Restore from get_state()'s form (or convert.
        learner_state_from_numpy's), placing every leaf on this learner's
        device in the master-weight dtype."""
        params = params_from_numpy(self.cfg.model, state["params"],
                                   device=self.device, master_weights=True)
        leaves = _leaves(params)
        opt = state["opt_state"]

        def moments(arrs) -> List[torch.Tensor]:
            if len(arrs) != len(leaves):
                raise ValueError(f"{len(arrs)} moments for {len(leaves)} "
                                 "parameter leaves")
            out = [self._place(a, p.dtype) for a, p in zip(arrs, leaves)]
            bad = [i for i, (m, p) in enumerate(zip(out, leaves))
                   if m.shape != p.shape]
            if bad:
                raise ValueError(f"moments of leaves {bad} do not have "
                                 "their parameter's shape")
            return out
        self.state = TrainState(
            int(state["step"]), params,
            AdamWState(int(opt.count), moments(opt.mu), moments(opt.nu)))
