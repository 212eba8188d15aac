# Verbatim copy of theoremsearch_tpu/core/config.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""Dataclass + JSON configuration system.

Replaces the reference's per-CLI argparse sprawl (every ec2/*/__main__.py)
and its registry dicts (ec2/generate_embeddings/embedders.py:1,
ec2/generate_slogans/models.py:1) with typed configs serializable to JSON.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


def _from_dict(cls, data: dict[str, Any]):
    """Build a dataclass from a dict, recursing into nested dataclass fields.

    Field types resolve through typing.get_type_hints: under
    `from __future__ import annotations` f.type is a STRING, so an
    is_dataclass(f.type) check would never recurse."""
    import typing

    try:
        hints = typing.get_type_hints(cls)
    except Exception:  # unresolvable forward refs: fall back to raw types
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        val = data[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(val, dict):
            val = _from_dict(ftype, val)
        kwargs[f.name] = val
    return cls(**kwargs)


class _JsonConfig:
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True))

    @classmethod
    def from_dict(cls, data: dict[str, Any]):
        return _from_dict(cls, data)

    @classmethod
    def from_json(cls, path: str | Path):
        return cls.from_dict(json.loads(Path(path).read_text()))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MeshConfig(_JsonConfig):
    """Logical device mesh layout.

    ``data`` parallelizes query/encode batches; ``shard`` partitions the
    corpus embedding matrix across chips (the TPU-native replacement for
    the reference's single-Postgres-instance pgvector scan).
    """

    data: int = 1
    shard: int = 1
    # axis names, kept stable so sharding rules can refer to them
    data_axis: str = "data"
    shard_axis: str = "shard"


@dataclass(frozen=True)
class IndexConfig(_JsonConfig):
    """Flat / IVF index layout knobs."""

    dim: int = 1024                 # qwen 1024 (reference rds_schema.sql:51)
    dtype: str = "bfloat16"         # bf16 | int8 (equal-memory knob)
    int8_scale: str = "perrow"      # perrow | global (global unlocks the
                                    # fused int32 speed path; pair with
                                    # rescoring)
    # capacity-mode rescore data (int8_scale == "global" only): ALSO pack
    # per-row int8 codes of the residual x - gscale*codes. The engine then
    # rescores from the two-level reconstruction (~15 effective bits) at
    # 2 bytes/dim total — no bf16 copy (kernels/mips.py
    # device_rescore_residual)
    residual: bool = False
    row_block: int = 1024           # corpus rows per kernel tile; multiple of 8
    pad_multiple: int = 1024        # shard row counts padded to this
    # IVF coarse quantizer (0 = flat exact index)
    ivf_nlist: int = 0
    ivf_nprobe: int = 8
    # True when ivf_nprobe came from calibrate_nprobe against the recall
    # gate — the engine then trusts it verbatim (otherwise it floors the
    # default at 16, the safe value for easy geometry)
    ivf_nprobe_calibrated: bool = False
    kmeans_iters: int = 25
    kmeans_init: str = "kmeans++"   # or "random"; ++ avoids merged
                                    # clusters on well-separated corpora
    # dual assignment: rows whose 2nd-best centroid scores within this
    # margin of the best are ALSO stored in that cluster (when its slab
    # has room) — boundary rows then survive a missed primary probe.
    # 0 disables. Copies are dropped, never spilled (the primary exists).
    ivf_assign2_margin: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class EncoderConfig(_JsonConfig):
    """Qwen3-Embedding-0.6B-class architecture (the reference's chosen
    embedder: compare_embeddings.py:466 "Qwen3 0.6B is the best")."""

    vocab_size: int = 151_669
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 512
    embedding_dim: int = 1024       # output embedding dim (== hidden for qwen)
    pooling: str = "last_token"     # qwen3-embedding pools the EOS position
    normalize: bool = True          # reference normalize_embeddings=True everywhere
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        """A small config for tests/dry-runs."""
        return cls(
            vocab_size=1024,
            hidden_size=128,
            intermediate_size=256,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=32,
            max_seq_len=64,
            embedding_dim=128,
        )


@dataclass(frozen=True)
class GemmaEncoderConfig(_JsonConfig):
    """EmbeddingGemma-300m-class architecture — the reference's second
    embedder alias ({"gemma": "google/embeddinggemma-300m"},
    ec2/generate_embeddings/embedders.py:1-4; 768-dim pgvector table
    rds_schema.sql:52-57).

    A Gemma3 text tower run bidirectionally (HF Gemma3TextModel with
    use_bidirectional_attention=True) + the sentence-transformers head:
    mean pooling -> Dense(hidden->head_hidden) -> Dense(head_hidden->
    embedding_dim) -> L2 normalize. Differences from the Qwen3 tower
    that matter numerically: embeddings scaled by sqrt(hidden);
    (1+w)-form RMSNorm with zero-init weights; sandwich norms around
    both attention and MLP; GeGLU (tanh-approx gelu); 5:1 local:global
    attention layers with separate RoPE bases; attention scaled by
    query_pre_attn_scalar**-0.5 instead of head_dim**-0.5."""

    vocab_size: int = 262_144
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_layers: int = 24
    num_heads: int = 3
    num_kv_heads: int = 1
    head_dim: int = 256
    rope_theta: float = 1_000_000.0        # global-attention layers
    rope_local_theta: float = 10_000.0     # sliding-attention layers
    rope_scaling_factor: float = 1.0       # linear rope_scaling on global layers
    sliding_window: int = 512
    global_every: int = 6                  # layer i is global iff (i+1) % 6 == 0
    query_pre_attn_scalar: float = 256.0
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 512
    head_hidden: int = 3072                # sentence-transformers Dense bottleneck
    embedding_dim: int = 768
    normalize: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    @classmethod
    def tiny(cls) -> "GemmaEncoderConfig":
        """A small config for tests/dry-runs."""
        return cls(
            vocab_size=1024,
            hidden_size=96,
            intermediate_size=192,
            num_layers=4,
            num_heads=3,
            num_kv_heads=1,
            head_dim=32,
            sliding_window=16,
            global_every=2,
            query_pre_attn_scalar=32.0,
            max_seq_len=64,
            head_hidden=128,
            embedding_dim=96,
        )


@dataclass(frozen=True)
class BertEncoderConfig(_JsonConfig):
    """BERT-base-class architecture — the reference's third embedder
    (zbMath BERT, 768-dim table rds_schema.sql:45-50; one of the three
    compared in compare_embeddings.py:429-470). Standard post-LayerNorm
    bidirectional transformer with learned absolute positions, biased
    projections and exact-GELU FFN; sentence-transformers mean pooling +
    L2 normalize."""

    vocab_size: int = 30_522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    type_vocab_size: int = 2
    hidden_act: str = "gelu"        # "gelu" (exact) | "gelu_new" (tanh)
    layer_norm_eps: float = 1e-12
    max_seq_len: int = 512
    embedding_dim: int = 768
    normalize: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    @classmethod
    def tiny(cls) -> "BertEncoderConfig":
        """A small config for tests/dry-runs."""
        return cls(
            vocab_size=1024,
            hidden_size=96,
            intermediate_size=192,
            num_layers=3,
            num_heads=4,
            max_seq_len=64,
            embedding_dim=96,
        )


@dataclass(frozen=True)
class SearchConfig(_JsonConfig):
    """Query-path knobs (the streamlit_app.py backend feature set)."""

    top_k: int = 10
    # citation-weighted rerank: pool = max(min_pool, pool_multiple*top_k),
    # score = similarity + weight*ln(citations)  (streamlit_app.py:317,353-363)
    citation_weight: float = 0.0
    rerank_min_pool: int = 50
    rerank_pool_multiple: int = 10
    query_batch: int = 256          # queries scored per kernel launch


@dataclass(frozen=True)
class TrainConfig(_JsonConfig):
    """Contrastive fine-tuning of the encoder (InfoNCE over query/slogan pairs)."""

    batch_size: int = 32
    seq_len: int = 64
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    temperature: float = 0.05
    steps: int = 100
    seed: int = 0
    # parameter-efficient mode (train/lora.py): 0 = full fine-tune;
    # rank > 0 freezes the base encoder and trains low-rank deltas on
    # lora_targets (None = the ("wq", "wv") default)
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple | None = None
