"""The port's LLM serving engine."""

from .llm import GenRequest, LLMEngine, LLMServer, default_buckets

__all__ = ["GenRequest", "LLMEngine", "LLMServer", "default_buckets"]
