"""Training step on one device: the counterpart of the JAX package's
``train/step.py`` (``make_optimizer``, ``TrainState``, ``init_state``,
``make_train_step``, ``make_eval_step``) without a mesh.

The optimizer is optax's chain ``clip_by_global_norm(grad_clip)`` then
``adamw(warmup_cosine_decay_schedule(...), b1, b2, weight_decay)``,
written out so that each update computes what optax computes:

- the schedule is read at the count *before* the update, so the first
  update uses lr 0 and (the weight decay being scaled by the lr too)
  moves nothing; its cosine part spans ``decay_steps - warmup`` steps,
  where the JAX code passes ``decay_steps = max(total, warmup + 1)``;
- the clip leaves the grads as they are when their global norm is below
  ``grad_clip`` and otherwise takes ``g / norm * grad_clip`` (no
  epsilon: ``torch.nn.utils.clip_grad_norm_`` adds 1e-6, so it is not
  this);
- Adam's moments are bias-corrected with t = count + 1 and the update is
  ``mu_hat / (sqrt(nu_hat) + 1e-8)`` (eps_root 0);
- the weight decay is added to that update for every leaf (norm scales
  and embedding included: there is no mask), and the sum is scaled by
  the lr.

The moments live in the params' dtype (f32 beside f32 master weights).
The step count and the optimizer's count are host integers: they are
known on the host, so the lr is a host float and nothing in a step waits
for the device. Where the JAX step donates its input state
(``donate_argnums=(0,)``) the port updates params and moments in place
with ``torch._foreach_*``: the returned state holds the same tensors as
the one passed in, which must not be used again.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .._device import DeviceLike
from ..models.configs import TransformerConfig
from ..models.transformer import Metrics, Params, init_params, loss_fn


def _leaves(tree: Params) -> List[torch.Tensor]:
    """The leaves of a parameter dictionary in a fixed (key-sorted)
    order."""
    out: List[torch.Tensor] = []
    for key in sorted(tree):
        val = tree[key]
        out += _leaves(val) if isinstance(val, dict) else [val]
    return out


def _rebuild(tree: Params, leaves: List[torch.Tensor]) -> Params:
    """A dictionary of tree's structure holding `leaves` (in _leaves'
    order)."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return build(tree)


class AdamWState(NamedTuple):
    count: int                     # updates done (optax's count)
    mu: List[torch.Tensor]         # first moments, in _leaves order
    nu: List[torch.Tensor]         # second moments


class TrainState(NamedTuple):
    step: int
    params: Params
    opt_state: AdamWState


ADAM_EPS = 1e-8        # optax.adamw's default eps (eps_root 0)


@dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm(grad_clip) then adamw with a warmup-cosine
    schedule, with optax's semantics (see the module docstring). Build it
    with make_optimizer."""

    lr: float
    warmup_steps: int
    total_steps: int
    weight_decay: float
    b1: float
    b2: float
    grad_clip: float

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
        max(total_steps, warmup_steps + 1), 0.1 * lr) at `count`: a
        linear warmup from 0, then a cosine decay to 0.1 * lr over the
        rest of the decay steps."""
        if count < self.warmup_steps:
            frac = 1.0 - count / self.warmup_steps
            return -self.lr * frac + self.lr
        span = max(self.total_steps, self.warmup_steps + 1) \
            - self.warmup_steps
        t = min(count - self.warmup_steps, span)
        alpha = 0.1                    # end value / peak value
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return self.lr * ((1.0 - alpha) * cosine + alpha)

    def init(self, params: Params) -> AdamWState:
        leaves = _leaves(params)
        return AdamWState(0, [torch.zeros_like(p) for p in leaves],
                          [torch.zeros_like(p) for p in leaves])

    @staticmethod
    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares of every grad (optax.global_norm),
        a 0-d f32 tensor on the grads' device."""
        norms = torch._foreach_norm([g.float() for g in grads])
        return torch.linalg.vector_norm(torch.stack(norms))

    @torch.no_grad()
    def update_(self, grads: List[torch.Tensor], state: AdamWState,
                params: List[torch.Tensor], gnorm: torch.Tensor
                ) -> AdamWState:
        """One update, in place on `params` (and on `grads`, which it
        clips, and the moments). `gnorm` is global_norm(grads)."""
        clip = gnorm >= self.grad_clip
        one = torch.ones_like(gnorm)
        torch._foreach_div_(grads, torch.where(clip, gnorm, one))
        torch._foreach_mul_(grads, torch.where(clip, one * self.grad_clip,
                                               one))
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        t = state.count + 1
        den = torch._foreach_div(nu, 1.0 - self.b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** t)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-self.schedule(state.count))
        return AdamWState(t, mu, nu)


def make_optimizer(lr: float = 3e-4, *, warmup_steps: int = 100,
                   total_steps: int = 10_000, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0) -> Optimizer:
    """The JAX package's make_optimizer."""
    return Optimizer(lr=lr, warmup_steps=warmup_steps,
                     total_steps=total_steps, weight_decay=weight_decay,
                     b1=b1, b2=b2, grad_clip=grad_clip)


def init_state(cfg: TransformerConfig, optimizer: Optimizer, seed: int = 0,
               *, device: DeviceLike = "cuda") -> TrainState:
    """Master weights (every leaf in cfg.param_dtype) from `seed` on
    `device`, zero moments, step 0."""
    params = init_params(cfg, seed, device=device, master_weights=True)
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params))


LossFn = Callable[..., Tuple[torch.Tensor, Metrics]]


def make_train_step(cfg: TransformerConfig, optimizer: Optimizer, *,
                    loss: Optional[LossFn] = None):
    """Returns step(state, tokens, targets, mask=None) -> (state, metrics).
    It runs on the device the params live on. `loss` overrides the loss
    (loss_fn's signature without cfg). Metrics are the loss's (loss, ce,
    aux, tokens) plus grad_norm, the global norm of the raw grads, all
    0-d tensors (read them on the host when needed: the step does not)."""

    def _loss(params, tokens, targets, mask):
        if loss is not None:
            return loss(params, tokens, targets, mask)
        return loss_fn(cfg, params, tokens, targets, mask)

    def train_step(state: TrainState, tokens: torch.Tensor,
                   targets: torch.Tensor, mask: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, Metrics]:
        leaves = _leaves(state.params)
        # Grad-tracking aliases of the stored weights (same storage): the
        # stored tensors themselves never require grad.
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            total, metrics = _loss(_rebuild(state.params, live), tokens,
                                   targets, mask)
            grads = list(torch.autograd.grad(total, live))
        del live
        gnorm = optimizer.global_norm(grads)
        opt_state = optimizer.update_(grads, state.opt_state, leaves, gnorm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return train_step


def make_eval_step(cfg: TransformerConfig):
    """Returns eval_step(params, tokens, targets, mask=None) -> metrics,
    without autograd."""

    @torch.no_grad()
    def eval_step(params: Params, tokens: torch.Tensor,
                  targets: torch.Tensor, mask: Optional[torch.Tensor] = None
                  ) -> Metrics:
        return loss_fn(cfg, params, tokens, targets, mask)[1]

    return eval_step
