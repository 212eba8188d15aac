"""The deepseek-family configuration of the benchmark (Moonlight-16B-A3B):
its published keys as run, the program's config, weights from the seed,
the encoder the CLI builds, and the yardstick's counts for the tower and
for the grouped expert kernel. The port is imported in the builders only.

A configuration file holds the published `config.json` keys at its top
level; its `model` group, empty in the file, overrides them (the tests'
tiny sizes come in that way)."""

from __future__ import annotations

import torch

from . import counts, textgen

KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads", "q_lora_rank",
        "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "first_k_dense_replace", "intermediate_size", "moe_intermediate_size",
        "n_routed_experts", "num_experts_per_tok", "n_shared_experts", "routed_scaling_factor",
        "norm_topk_prob", "scoring_func", "topk_method", "rope_theta", "rms_norm_eps")
GROUPED_KERNEL = "moe_grouped_gemm_kernel"


def model_of(cfg: dict) -> dict:
    """The tower's keys as run: the published ones, then `model`'s."""
    return {**{k: cfg[k] for k in KEYS}, **cfg.get("model", {})}


def program_config(cfg: dict):
    from theoremsearch_tpu_torch.encoder.deepseek import DeepseekEncoderConfig

    m = model_of(cfg)
    return DeepseekEncoderConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_layers=m["num_hidden_layers"], num_heads=m["num_attention_heads"],
        q_lora_rank=m["q_lora_rank"], kv_lora_rank=m["kv_lora_rank"],
        qk_nope_head_dim=m["qk_nope_head_dim"], qk_rope_head_dim=m["qk_rope_head_dim"],
        v_head_dim=m["v_head_dim"], first_k_dense_replace=m["first_k_dense_replace"],
        intermediate_size=m["intermediate_size"], moe_intermediate_size=m["moe_intermediate_size"],
        n_routed_experts=m["n_routed_experts"], num_experts_per_tok=m["num_experts_per_tok"],
        n_shared_experts=m["n_shared_experts"], routed_scaling_factor=m["routed_scaling_factor"],
        norm_topk_prob=m["norm_topk_prob"], scoring_func=m["scoring_func"],
        topk_method=m["topk_method"], rope_theta=float(m["rope_theta"]),
        rms_norm_eps=m["rms_norm_eps"], max_seq_len=cfg["serving"]["max_seq_len"],
        embedding_dim=m["hidden_size"])


def make_params(m: dict, seed: int, device) -> dict:
    """The tower's parameters drawn from `seed` on `device`, in the port's
    layout (`encoder/deepseek.py`): matrices N(0, 0.02^2) in bf16, the
    router's weight N(0, 0.02^2) in f32, norm gains 1 + 0.1 N(0, 1) and
    e_score_correction_bias 0.02 N(0, 1) in f32; each tensor drawn in turn
    from one generator."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    h, nh, r = m["hidden_size"], m["num_attention_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]

    def mat(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(0.02)

    def gain(n):
        return torch.randn((n,), generator=gen, device=device).mul_(0.1).add_(1.0)

    layers = []
    for li in range(m["num_hidden_layers"]):
        layer = {"attn_norm": gain(h), "wq": mat(h, nh * (dn + dr)), "wkv_a": mat(h, r + dr),
                 "kv_norm": gain(r), "wkv_b": mat(r, nh * (dn + dv)), "wo": mat(nh * dv, h),
                 "mlp_norm": gain(h)}
        if li < m["first_k_dense_replace"]:
            i = m["intermediate_size"]
            layer.update(w_gate=mat(h, i), w_up=mat(h, i), w_down=mat(i, h))
        else:
            e, i = m["n_routed_experts"], m["moe_intermediate_size"]
            si = m["n_shared_experts"] * i
            layer.update(router=mat(e, h, dtype=torch.float32),
                         router_bias=torch.randn((e,), generator=gen, device=device).mul_(0.02),
                         experts_gate=mat(e, i, h), experts_up=mat(e, i, h),
                         experts_down=mat(e, h, i),
                         shared={"w_gate": mat(h, si), "w_up": mat(h, si), "w_down": mat(si, h)})
        layers.append(layer)
    return {"embed": mat(m["vocab_size"], h), "final_norm": gain(h), "layers": layers}


def make_weights(cfg: dict, seed: int, device) -> dict:
    return make_params(model_of(cfg), textgen.torch_seed(seed, "weights"), device)


def batched_encoder(cfg: dict, params: dict, device):
    """The encoder the CLI's embed command builds (the hermetic hash
    tokenizer, no role prompts), in bf16."""
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.tokenizer import SimpleTokenizer

    pcfg = program_config(cfg)
    return BatchedEncoder(params, pcfg, tokenizer=SimpleTokenizer(vocab_size=pcfg.vocab_size),
                          prompts={}, quant="none", device=device)


def active_params(m: dict) -> int:
    """Parameters a real token multiplies its activations by, outside the
    embedding: the latent attention's projections and norms in every
    layer, the dense layers' SwiGLU, and in each expert layer the router,
    the k picked experts and the shared experts; the final norm."""
    h, nh, r = m["hidden_size"], m["num_attention_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    attn = h * nh * (dn + dr) + h * (r + dr) + r + r * nh * (dn + dv) + nh * dv * h + 2 * h
    dense = 3 * h * m["intermediate_size"]
    im = m["moe_intermediate_size"]
    expert = (m["n_routed_experts"] * h + m["n_routed_experts"]
              + (m["num_experts_per_tok"] + m["n_shared_experts"]) * 3 * h * im)
    n, fk = m["num_hidden_layers"], m["first_k_dense_replace"]
    return n * attn + fk * dense + (n - fk) * expert + h


def model_flops(m: dict, lengths) -> float:
    """FLOPs of one forward over sequences of these real lengths: 2 x the
    active parameters a token, plus the latent attention's products, 2 x
    heads x (nope + rope + v) FLOPs a causal pair a layer."""
    p = active_params(m)
    width = m["num_attention_heads"] * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
                                         + m["v_head_dim"])
    n = m["num_hidden_layers"]
    return sum(2.0 * p * ln + n * 2.0 * width * ln * (ln + 1) / 2 for ln in lengths)


def grouped_bound_ms(m: dict, pairs: int, touched: int) -> float:
    """The least time of the grouped expert products over `pairs` routed
    rows touching `touched` (expert, layer) weight sets: bytes = the
    touched experts' three bf16 matrices plus the pairs' rows in and out
    of both products; operations = 2 x pairs x 3 x H x I in bf16."""
    h, im = m["hidden_size"], m["moe_intermediate_size"]
    nbytes = touched * 3 * h * im * 2 + pairs * (h * 2 + im * 2) * 2
    return counts.bound(nbytes, {"bf16": 2.0 * pairs * 3 * h * im})["bound_ms"]
