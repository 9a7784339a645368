"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's model and serving path.

A package of its own beside the JAX package: it imports torch, never jax,
and nothing of ``ray_tpu``. This slice serves the dense Llama-family
decoder on one GPU through ``LLMServer``/``LLMEngine``, with prompt and
prefix-suffix prefill attention running a hand-written CUDA
flash-attention forward (``ops/csrc/flash_attn_fwd.cu``).

Entry points run on the GPU unless the caller passes ``device="cpu"``.
Importing the package builds nothing and makes no CUDA call: the kernel
is compiled with nvcc at its first launch.
"""

from .convert import params_from_numpy
from .models import configs
from .models.configs import TransformerConfig
from .models.generate import greedy_generate
from .models.transformer import forward, init_params
from .ops.flash_attention import flash_attention
from .serve.llm import GenRequest, LLMEngine, LLMServer

__all__ = [
    "GenRequest",
    "LLMEngine",
    "LLMServer",
    "TransformerConfig",
    "configs",
    "flash_attention",
    "forward",
    "greedy_generate",
    "init_params",
    "params_from_numpy",
]
