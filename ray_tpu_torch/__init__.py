"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's model, serving and
training path.

A package of its own beside the JAX package: it imports torch, never jax,
and nothing of ``ray_tpu``. It serves the dense Llama-family decoder on
one GPU through ``LLMServer``/``LLMEngine`` (prompt and prefix-suffix
prefill attention on a hand-written CUDA flash-attention forward,
``ops/csrc/flash_attn_fwd.cu``), trains it on one GPU through
``init_state``/``make_train_step`` (attention's backward on hand-written
CUDA dq and dk/dv kernels, ``ops/csrc/flash_attn_bwd.cu``), and runs
GRPO RLHF on one GPU from both (``GRPOLearner``, ``RolloutWorker``).

Entry points run on the GPU unless the caller passes ``device="cpu"``.
Importing the package builds nothing and makes no CUDA call: each kernel
is compiled with nvcc at its first launch.
"""

from .convert import learner_state_from_numpy, params_from_numpy
from .models import configs
from .models.configs import TransformerConfig
from .models.generate import greedy_generate
from .models.transformer import forward, init_params, loss_fn
from .ops.flash_attention import flash_attention
from .rlhf import (
    GRPOLearner,
    GRPOLearnerConfig,
    RolloutWorker,
    learner_inputs,
    make_grpo_step,
)
from .serve.llm import GenRequest, LLMEngine, LLMServer
from .train import (
    TrainState,
    init_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "GRPOLearner",
    "GRPOLearnerConfig",
    "GenRequest",
    "LLMEngine",
    "LLMServer",
    "RolloutWorker",
    "TrainState",
    "TransformerConfig",
    "configs",
    "flash_attention",
    "forward",
    "greedy_generate",
    "init_params",
    "init_state",
    "learner_inputs",
    "learner_state_from_numpy",
    "loss_fn",
    "make_eval_step",
    "make_grpo_step",
    "make_optimizer",
    "make_train_step",
    "params_from_numpy",
]
