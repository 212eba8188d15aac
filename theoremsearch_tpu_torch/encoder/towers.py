"""Config type -> tower module for every tower the port runs: the deepseek
tower (`deepseek.py`), which the JAX package does not have, and the three
families of the verbatim `families.family_module` (qwen, gemma, BERT).
The batching layer, the CLI and the trainer dispatch through here."""

from __future__ import annotations

from .deepseek import DeepseekEncoderConfig
from .families import family_module


def tower_module(cfg):
    """The model module for a config instance."""
    if isinstance(cfg, DeepseekEncoderConfig):
        from . import deepseek

        return deepseek
    return family_module(cfg)


def routes_real_tokens(cfg) -> bool:
    """Whether the tower routes only the real tokens, whose rows the caller
    passes as `tokens` (read from its host mask)."""
    return isinstance(cfg, DeepseekEncoderConfig)
