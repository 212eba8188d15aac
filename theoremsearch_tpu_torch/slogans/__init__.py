# Verbatim copy of theoremsearch_tpu/slogans/__init__.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
from .prompts import PromptConfig, load_prompt
from .client import LLMClient, OfflineStubClient, get_client, MODELS
from .generate import generate_slogans
from .cost import format_usd, CostTracker

__all__ = [
    "PromptConfig",
    "load_prompt",
    "LLMClient",
    "OfflineStubClient",
    "get_client",
    "MODELS",
    "generate_slogans",
    "format_usd",
    "CostTracker",
]
