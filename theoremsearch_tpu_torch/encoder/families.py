# Verbatim copy of theoremsearch_tpu/encoder/families.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Config-type -> model-module dispatch for the three encoder families.

One place decides which module's encode_pooled / init_params /
shard_params a given config drives; the batching layer, the trainer and
any other family-generic code share it."""

from __future__ import annotations

from ..core.config import BertEncoderConfig, GemmaEncoderConfig


def family_module(cfg):
    """The model module (model / gemma / bert) for a config instance."""
    if isinstance(cfg, GemmaEncoderConfig):
        from . import gemma

        return gemma
    if isinstance(cfg, BertEncoderConfig):
        from . import bert

        return bert
    from . import model

    return model
