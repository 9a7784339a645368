"""GRPO RLHF on one device: the learner (``learner.GRPOLearner``) and the
generator (``rollout.RolloutWorker``) of the JAX package's ``rlhf/``.
The loop that joins them (rollout, reward, update, weight refresh) is the
caller's; the JAX package's actor pipeline is not ported yet."""

from .learner import GRPOLearner, GRPOLearnerConfig, make_grpo_step
from .rollout import RolloutWorker, learner_inputs

__all__ = ["GRPOLearner", "GRPOLearnerConfig", "RolloutWorker",
           "learner_inputs", "make_grpo_step"]
