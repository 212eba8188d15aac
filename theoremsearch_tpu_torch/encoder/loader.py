"""Checkpoint loading for the three towers: HuggingFace safetensors ->
the port's params (port of theoremsearch_tpu/encoder/loader.py).

`.safetensors` files are read by a short numpy reader (`read_safetensors`:
an 8-byte little-endian header length, a JSON header, then raw
little-endian buffers), so no `safetensors` package is needed; bf16
tensors arrive as their uint16 bits and become torch bf16 without a
rounding. HF stores Linear weights as (out, in); the port stores (in,
out), as the reference does, hence the transposes. Matrices come out in
`dtype` (bf16 by default), norms, biases and LayerNorm parameters in f32.

Name mapping, qwen (Qwen3Model or ForCausalLM-style, with or without a
"model." prefix; lm_head is skipped):
    embed_tokens.weight -> embed, norm.weight -> final_norm,
    layers.{i}.{input_layernorm, post_attention_layernorm} -> attn_norm,
    mlp_norm; self_attn.{q,k,v,o}_proj -> wq/wk/wv/wo, self_attn.{q,k}_norm
    -> q_norm/k_norm, mlp.{gate,up,down}_proj -> w_gate/w_up/w_down.
Name mapping, gemma (Gemma3TextModel, with or without a "model." prefix):
    embed_tokens.weight -> embed, norm.weight -> final_norm,
    layers.{i}.{input_layernorm, post_attention_layernorm,
    pre_feedforward_layernorm, post_feedforward_layernorm} -> attn_norm,
    post_attn_norm, pre_mlp_norm, post_mlp_norm; self_attn.{q,k,v,o}_proj
    -> wq/wk/wv/wo, self_attn.{q,k}_norm -> q_norm/k_norm,
    mlp.{gate,up,down}_proj -> w_gate/w_up/w_down; the sentence-transformers
    Dense dirs (2_Dense, 3_Dense) -> head_w1/head_b1, head_w2/head_b2.
BERT (BertModel, with or without a "bert." prefix): see _BERT_LAYER_MAPPING.
Name mapping, deepseek (DeepseekV3 / Moonlight, model_type deepseek_v3; a
port-only tower, `encoder/deepseek.py`): embed_tokens.weight -> embed,
norm.weight -> final_norm, layers.{i}.{input_layernorm,
post_attention_layernorm} -> attn_norm, mlp_norm; self_attn.{q_proj,
kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj, o_proj} -> wq, wkv_a,
kv_norm, wkv_b, wo; dense layers mlp.{gate,up,down}_proj -> w_gate, w_up,
w_down; expert layers mlp.gate.{weight, e_score_correction_bias} ->
router, router_bias (f32, as stored), mlp.experts.{e}.{gate,up,down}_proj
-> experts_gate[e], experts_up[e], experts_down[e] (kept (out, in)), and
mlp.shared_experts.{gate,up,down}_proj -> shared.{w_gate, w_up, w_down}.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..core.config import BertEncoderConfig, EncoderConfig, GemmaEncoderConfig
from ..utils.device import resolve_device
from .deepseek import DeepseekEncoderConfig
from .model import _DTYPES

# safetensors dtype tags -> numpy; BF16 is read as its uint16 bits
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file as a CPU tensor (bf16 for
    BF16, the numpy type's counterpart otherwise). The file is mapped, not
    read whole; each tensor is copied out of the mapping once."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    n = int.from_bytes(mm[:8].tobytes(), "little")
    header = json.loads(mm[8 : 8 + n].tobytes())
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: unsupported safetensors dtype {info['dtype']} ({name})")
        lo, hi = info["data_offsets"]
        dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
        a = np.array(mm[base + lo : base + hi].view(dt).reshape(info["shape"]), dtype=dt.newbyteorder("="))
        t = torch.from_numpy(a)
        out[name] = t.view(torch.int16).view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def _iter_safetensors(model_dir: Path):
    files = sorted(Path(model_dir).glob("*.safetensors"))
    if not files:
        raise ValueError(f"no .safetensors file in {model_dir}")
    for f in files:
        yield from read_safetensors(f).items()


def _to_param(t: torch.Tensor, transpose: bool, norm: bool, pdtype, device) -> torch.Tensor:
    if transpose:
        t = t.T
    return t.to(torch.float32 if norm else pdtype).contiguous().to(device)


def _load_decoder_tower(model_dir: Path, num_layers: int, mapping: dict, pdtype,
                        device) -> tuple[dict, list[int]]:
    """(params, indices of incomplete layers) of a qwen- or gemma-layout
    tower: embed, final_norm and each layer's `mapping` keys. The caller
    raises on incomplete layers or a missing embed."""
    layers: list[dict] = [dict() for _ in range(num_layers)]
    params: dict = {"layers": layers}
    for name, t in _iter_safetensors(model_dir):
        if name.startswith("lm_head."):
            continue
        # bare Qwen3Model / Gemma3TextModel keys gain the "model." prefix
        # that ForCausalLM-style (and the published embedding) checkpoints carry
        if not name.startswith("model.") and (
                name in ("embed_tokens.weight", "norm.weight") or name.startswith("layers.")):
            name = "model." + name
        if name == "model.embed_tokens.weight":
            params["embed"] = _to_param(t, False, False, pdtype, device)
        elif name == "model.norm.weight":
            params["final_norm"] = _to_param(t, False, True, pdtype, device)
        elif name.startswith("model.layers."):
            li, sub = name[len("model.layers."):].split(".", 1)
            if sub in mapping:
                key, tr, is_norm = mapping[sub]
                layers[int(li)][key] = _to_param(t, tr, is_norm, pdtype, device)
    return params, [i for i, layer in enumerate(layers) if len(layer) != len(mapping)]


# ---------------------------------------------------------------------------
# qwen family
# ---------------------------------------------------------------------------


def config_from_hf(model_dir: str | Path) -> EncoderConfig:
    """The EncoderConfig of a Qwen3 checkpoint's config.json."""
    cfg = json.loads((Path(model_dir) / "config.json").read_text())
    return EncoderConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim", cfg["hidden_size"] // cfg["num_attention_heads"]),
        rope_theta=cfg.get("rope_theta", 1_000_000.0),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        embedding_dim=cfg["hidden_size"],
    )


_QWEN_MAPPING = {
    "input_layernorm.weight": ("attn_norm", False, True),
    "self_attn.q_proj.weight": ("wq", True, False),
    "self_attn.k_proj.weight": ("wk", True, False),
    "self_attn.v_proj.weight": ("wv", True, False),
    "self_attn.o_proj.weight": ("wo", True, False),
    "self_attn.q_norm.weight": ("q_norm", False, True),
    "self_attn.k_norm.weight": ("k_norm", False, True),
    "post_attention_layernorm.weight": ("mlp_norm", False, True),
    "mlp.gate_proj.weight": ("w_gate", True, False),
    "mlp.up_proj.weight": ("w_up", True, False),
    "mlp.down_proj.weight": ("w_down", True, False),
}


def load_hf_checkpoint(model_dir: str | Path, dtype: str = "bfloat16",
                       device=None) -> tuple[dict, EncoderConfig]:
    """(params, config) of a local HF Qwen3 checkpoint dir, on `device`
    (default: the card). An incomplete checkpoint raises."""
    model_dir = Path(model_dir)
    device = resolve_device(device)
    cfg = config_from_hf(model_dir)
    params, missing = _load_decoder_tower(model_dir, cfg.num_layers, _QWEN_MAPPING,
                                          _DTYPES[dtype], device)
    if "embed" not in params or missing:
        raise ValueError(f"incomplete checkpoint: missing layers {missing[:4]}...")
    return params, cfg


# ---------------------------------------------------------------------------
# gemma family
# ---------------------------------------------------------------------------


def detect_family(model_dir: str | Path) -> str:
    """'gemma' for Gemma3-text checkpoints, 'bert' for BERT-class ones,
    'qwen' otherwise (the reference's rule); and 'deepseek' for model_type
    deepseek_v3, the port's own tower."""
    cfg = json.loads((Path(model_dir) / "config.json").read_text())
    mt = str(cfg.get("model_type", "")).lower()
    if mt == "deepseek_v3":
        return "deepseek"
    if mt.startswith("gemma") or "use_bidirectional_attention" in cfg:
        return "gemma"
    archs = [str(a).lower() for a in cfg.get("architectures", [])]
    if mt == "bert" or any(a.startswith("bert") for a in archs):
        return "bert"   # 'distilbert...' excluded: another tensor layout
    return "qwen"


def gemma_config_from_hf(model_dir: str | Path) -> GemmaEncoderConfig:
    """The GemmaEncoderConfig of a checkpoint's config.json. The layer
    pattern comes from `layer_types` (every-Nth-global only) or
    `sliding_window_pattern`; `sliding_window` stays the raw window (the
    bidirectional W // 2 + 1 split happens in the forward)."""
    cfg = json.loads((Path(model_dir) / "config.json").read_text())
    n_layers = cfg["num_hidden_layers"]
    layer_types = cfg.get("layer_types")
    if layer_types:
        fulls = [i for i, t in enumerate(layer_types) if t == "full_attention"]
        if not fulls:
            global_every = n_layers + 1   # all sliding
        else:
            global_every = fulls[0] + 1
            want = [i for i in range(n_layers) if (i + 1) % global_every == 0]
            if fulls != want:
                raise ValueError(f"irregular layer_types (full at {fulls}); only the "
                                 "every-Nth-global pattern is supported")
    else:
        global_every = int(cfg.get("sliding_window_pattern", 6))
    scaling = cfg.get("rope_scaling") or {}
    factor = 1.0
    if scaling and scaling.get("rope_type", scaling.get("type", "default")) == "linear":
        factor = float(scaling.get("factor", 1.0))
    head_dim = cfg.get("head_dim", cfg["hidden_size"] // cfg["num_attention_heads"])
    return GemmaEncoderConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=n_layers,
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=head_dim,
        rope_theta=cfg.get("rope_theta", 1_000_000.0),
        rope_local_theta=cfg.get("rope_local_base_freq", 10_000.0),
        rope_scaling_factor=factor,
        sliding_window=cfg.get("sliding_window", 512),
        global_every=global_every,
        query_pre_attn_scalar=float(cfg.get("query_pre_attn_scalar", head_dim)),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        embedding_dim=cfg["hidden_size"],
    )


_GEMMA_MAPPING = {
    "input_layernorm.weight": ("attn_norm", False, True),
    "post_attention_layernorm.weight": ("post_attn_norm", False, True),
    "pre_feedforward_layernorm.weight": ("pre_mlp_norm", False, True),
    "post_feedforward_layernorm.weight": ("post_mlp_norm", False, True),
    "self_attn.q_proj.weight": ("wq", True, False),
    "self_attn.k_proj.weight": ("wk", True, False),
    "self_attn.v_proj.weight": ("wv", True, False),
    "self_attn.o_proj.weight": ("wo", True, False),
    "self_attn.q_norm.weight": ("q_norm", False, True),
    "self_attn.k_norm.weight": ("k_norm", False, True),
    "mlp.gate_proj.weight": ("w_gate", True, False),
    "mlp.up_proj.weight": ("w_up", True, False),
    "mlp.down_proj.weight": ("w_down", True, False),
}


def _load_st_dense(dense_dir: Path, pdtype, device):
    """One sentence-transformers Dense module dir: linear.weight (out, in)
    and an optional linear.bias -> ((in, out) weight, f32 bias)."""
    w = b = None
    for name, t in _iter_safetensors(dense_dir):
        if name.endswith("weight"):
            w = t
        elif name.endswith("bias"):
            b = t
    if w is None:
        raise ValueError(f"no linear.weight in {dense_dir}")
    bias = b if b is not None else torch.zeros(w.shape[0])
    return _to_param(w, True, False, pdtype, device), _to_param(bias, False, True, pdtype, device)


def load_hf_gemma_checkpoint(model_dir: str | Path, dtype: str = "bfloat16",
                             device=None) -> tuple[dict, GemmaEncoderConfig]:
    """(params, config) of a local EmbeddingGemma / Gemma3-text checkpoint,
    on `device` (default: the card). Sentence-transformers Dense module
    dirs beside the tower ('2_Dense', '3_Dense') become the projection
    head, and head_hidden / embedding_dim follow their shapes; without them
    the pooled hidden state is the embedding."""
    model_dir = Path(model_dir)
    device = resolve_device(device)
    cfg = gemma_config_from_hf(model_dir)
    pdtype = _DTYPES[dtype]
    params, missing = _load_decoder_tower(model_dir, cfg.num_layers, _GEMMA_MAPPING, pdtype,
                                          device)
    if "embed" not in params or missing:
        raise ValueError(f"incomplete gemma checkpoint: missing layers {missing[:4]}...")
    dense_dirs = sorted(d for d in model_dir.iterdir() if d.is_dir() and d.name.endswith("_Dense"))
    if dense_dirs:
        if len(dense_dirs) != 2:
            raise ValueError(f"expected 2 sentence-transformers Dense modules, found {dense_dirs}")
        params["head_w1"], params["head_b1"] = _load_st_dense(dense_dirs[0], pdtype, device)
        params["head_w2"], params["head_b2"] = _load_st_dense(dense_dirs[1], pdtype, device)
        cfg = replace(cfg, head_hidden=params["head_w1"].shape[1],
                      embedding_dim=params["head_w2"].shape[1])
    return params, cfg


def load_st_prompts(model_dir: str | Path) -> dict:
    """Role prompts from config_sentence_transformers.json ("prompts":
    name -> text prefix); {} when the file is absent. A file that exists
    but cannot be read warns (serving prompt-less queries against a
    prompted corpus would be silent otherwise)."""
    p = Path(model_dir) / "config_sentence_transformers.json"
    if not p.exists():
        return {}
    try:
        cfg = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        warnings.warn(f"unreadable {p.name} ({e}); role prompts DISABLED")
        return {}
    prompts = cfg.get("prompts") or {}
    return {str(k): str(v) for k, v in prompts.items()}


# ---------------------------------------------------------------------------
# bert family
# ---------------------------------------------------------------------------


def bert_config_from_hf(model_dir: str | Path) -> BertEncoderConfig:
    cfg = json.loads((Path(model_dir) / "config.json").read_text())
    act = cfg.get("hidden_act", "gelu")
    if act not in ("gelu", "gelu_new"):
        raise ValueError(f"unsupported BERT hidden_act {act!r}")
    return BertEncoderConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        type_vocab_size=cfg.get("type_vocab_size", 2),
        hidden_act=act,
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        max_seq_len=cfg.get("max_position_embeddings", 512),
        embedding_dim=cfg["hidden_size"],
    )


_BERT_LAYER_MAPPING = {
    "attention.self.query.weight": ("wq", True, False),
    "attention.self.query.bias": ("bq", False, True),
    "attention.self.key.weight": ("wk", True, False),
    "attention.self.key.bias": ("bk", False, True),
    "attention.self.value.weight": ("wv", True, False),
    "attention.self.value.bias": ("bv", False, True),
    "attention.output.dense.weight": ("wo", True, False),
    "attention.output.dense.bias": ("bo", False, True),
    "attention.output.LayerNorm.weight": ("attn_ln_g", False, True),
    "attention.output.LayerNorm.bias": ("attn_ln_b", False, True),
    "intermediate.dense.weight": ("w_in", True, False),
    "intermediate.dense.bias": ("b_in", False, True),
    "output.dense.weight": ("w_out", True, False),
    "output.dense.bias": ("b_out", False, True),
    "output.LayerNorm.weight": ("mlp_ln_g", False, True),
    "output.LayerNorm.bias": ("mlp_ln_b", False, True),
}

_BERT_EMBED_MAPPING = {
    "embeddings.word_embeddings.weight": ("embed", False, False),
    "embeddings.position_embeddings.weight": ("pos_embed", False, False),
    "embeddings.token_type_embeddings.weight": ("type_embed", False, False),
    "embeddings.LayerNorm.weight": ("embed_ln_g", False, True),
    "embeddings.LayerNorm.bias": ("embed_ln_b", False, True),
}


def load_hf_bert_checkpoint(model_dir: str | Path, dtype: str = "bfloat16",
                            device=None) -> tuple[dict, BertEncoderConfig]:
    """(params, config) of a local BERT-class checkpoint (BertModel
    layout, with or without a 'bert.' prefix; the pooler and MLM heads are
    skipped: mean pooling is the inference path), on `device` (default:
    the card)."""
    model_dir = Path(model_dir)
    device = resolve_device(device)
    cfg = bert_config_from_hf(model_dir)
    pdtype = _DTYPES[dtype]
    layers: list[dict] = [dict() for _ in range(cfg.num_layers)]
    params: dict = {"layers": layers}
    for name, t in _iter_safetensors(model_dir):
        if name.startswith("bert."):
            name = name[len("bert."):]
        if name.startswith(("pooler.", "cls.")):
            continue
        if name in _BERT_EMBED_MAPPING:
            key, tr, is_norm = _BERT_EMBED_MAPPING[name]
            params[key] = _to_param(t, tr, is_norm, pdtype, device)
        elif name.startswith("encoder.layer."):
            li, sub = name[len("encoder.layer."):].split(".", 1)
            if sub in _BERT_LAYER_MAPPING:
                key, tr, is_norm = _BERT_LAYER_MAPPING[sub]
                layers[int(li)][key] = _to_param(t, tr, is_norm, pdtype, device)
    missing = [i for i, layer in enumerate(layers) if len(layer) != len(_BERT_LAYER_MAPPING)]
    if "embed" not in params or missing:
        raise ValueError(f"incomplete bert checkpoint: missing layers {missing[:4]}...")
    return params, cfg


# ---------------------------------------------------------------------------
# deepseek tower (port-only)
# ---------------------------------------------------------------------------


def deepseek_config_from_hf(model_dir: str | Path) -> DeepseekEncoderConfig:
    """The DeepseekEncoderConfig of a deepseek_v3 checkpoint's config.json.
    Raises on what the tower does not run: a low-rank W_q, grouped routing
    (n_group > 1), RoPE scaling, a layer pattern other than dense layers
    first."""
    cfg = json.loads((Path(model_dir) / "config.json").read_text())
    if cfg.get("n_group", 1) != 1 or cfg.get("topk_group", 1) != 1:
        raise ValueError("the deepseek tower takes n_group 1 (every expert in one group)")
    if cfg.get("rope_scaling") is not None:
        raise ValueError("the deepseek tower takes rope_scaling null")
    if cfg.get("moe_layer_freq", 1) != 1:
        raise ValueError("the deepseek tower takes moe_layer_freq 1")
    return DeepseekEncoderConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        q_lora_rank=cfg.get("q_lora_rank"), kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], first_k_dense_replace=cfg["first_k_dense_replace"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["n_routed_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        norm_topk_prob=bool(cfg["norm_topk_prob"]), scoring_func=cfg["scoring_func"],
        topk_method=cfg["topk_method"], rope_theta=float(cfg["rope_theta"]),
        rms_norm_eps=cfg["rms_norm_eps"], max_seq_len=512, embedding_dim=cfg["hidden_size"])


_DEEPSEEK_LAYER_MAPPING = {
    "input_layernorm.weight": ("attn_norm", False, True),
    "post_attention_layernorm.weight": ("mlp_norm", False, True),
    "self_attn.q_proj.weight": ("wq", True, False),
    "self_attn.kv_a_proj_with_mqa.weight": ("wkv_a", True, False),
    "self_attn.kv_a_layernorm.weight": ("kv_norm", False, True),
    "self_attn.kv_b_proj.weight": ("wkv_b", True, False),
    "self_attn.o_proj.weight": ("wo", True, False),
    "mlp.gate_proj.weight": ("w_gate", True, False),
    "mlp.up_proj.weight": ("w_up", True, False),
    "mlp.down_proj.weight": ("w_down", True, False),
    "mlp.gate.weight": ("router", False, True),
    "mlp.gate.e_score_correction_bias": ("router_bias", False, True),
}
_DEEPSEEK_EXPERT_KEYS = {"gate_proj": "experts_gate", "up_proj": "experts_up",
                         "down_proj": "experts_down"}


def load_hf_deepseek_checkpoint(model_dir: str | Path, dtype: str = "bfloat16",
                                device=None) -> tuple[dict, DeepseekEncoderConfig]:
    """(params, config) of a local deepseek_v3 checkpoint (with or without
    a "model." prefix; lm_head skipped), on `device` (default: the card).
    Each expert's matrices are copied into the layer's stacked (E, out,
    in) tensors as they are read."""
    model_dir = Path(model_dir)
    device = resolve_device(device)
    cfg = deepseek_config_from_hf(model_dir)
    pdtype = _DTYPES[dtype]
    h, e, i = cfg.hidden_size, cfg.n_routed_experts, cfg.moe_intermediate_size
    layers: list[dict] = [dict() for _ in range(cfg.num_layers)]
    seen: list[set] = [set() for _ in range(cfg.num_layers)]
    params: dict = {"layers": layers}
    for name, t in _iter_safetensors(model_dir):
        name = name[len("model."):] if name.startswith("model.") else name
        if name == "embed_tokens.weight":
            params["embed"] = _to_param(t, False, False, pdtype, device)
        elif name == "norm.weight":
            params["final_norm"] = _to_param(t, False, True, pdtype, device)
        elif name.startswith("layers."):
            li_s, sub = name[len("layers."):].split(".", 1)
            li = int(li_s)
            layer = layers[li]
            if sub in _DEEPSEEK_LAYER_MAPPING:
                key, tr, f32 = _DEEPSEEK_LAYER_MAPPING[sub]
                layer[key] = _to_param(t, tr, f32, pdtype, device)
                seen[li].add(key)
            elif sub.startswith("mlp.shared_experts."):
                proj = sub.split(".")[2]
                key = {"gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down"}[proj]
                layer.setdefault("shared", {})[key] = _to_param(t, True, False, pdtype, device)
                seen[li].add("shared." + key)
            elif sub.startswith("mlp.experts."):
                _, _, ei, proj, _ = sub.split(".")
                key = _DEEPSEEK_EXPERT_KEYS[proj]
                if key not in layer:
                    shape = (e, h, i) if key == "experts_down" else (e, i, h)
                    layer[key] = torch.empty(shape, dtype=pdtype, device=device)
                layer[key][int(ei)].copy_(t.to(pdtype))
                seen[li].add(f"{key}.{ei}")
    dense = {"attn_norm", "mlp_norm", "wq", "wkv_a", "kv_norm", "wkv_b", "wo", "w_gate", "w_up",
             "w_down"}
    routed = (dense - {"w_gate", "w_up", "w_down"}) | {"router", "router_bias"} | {
        f"shared.{k}" for k in ("w_gate", "w_up", "w_down")} | {
        f"{k}.{j}" for k in _DEEPSEEK_EXPERT_KEYS.values() for j in range(e)}
    missing = [li for li in range(cfg.num_layers)
               if seen[li] != (dense if li < cfg.first_k_dense_replace else routed)]
    if "embed" not in params or "final_norm" not in params or missing:
        raise ValueError(f"incomplete deepseek checkpoint: layers {missing[:4]} ...")
    return params, cfg
