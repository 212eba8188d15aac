"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel could take, and the model FLOPs of real tokens.

`HBM_BYTES_S`, `PEAK_OPS_S` and `bound` are frozen copies of the kernel
smoke's (H100 SXM data sheet, dense rates, 700 W)."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def bound(nbytes: float, ops: dict) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type
    (`ops` maps a type to its count; the times of the types add)."""
    tb = nbytes / HBM_BYTES_S
    to = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return {"bound_ms": 1e3 * max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def non_embedding_params(model: dict, family: str) -> int:
    """Parameters outside the embedding tables: every projection, bias and
    norm weight the forward multiplies a token's activations by."""
    h, i, n = model["hidden_size"], model["intermediate_size"], model["num_hidden_layers"]
    if family == "qwen":
        dh, nh, nk = model["head_dim"], model["num_attention_heads"], model["num_key_value_heads"]
        attn = h * nh * dh + 2 * h * nk * dh + nh * dh * h
        per_layer = attn + 3 * h * i + 2 * h + 2 * dh
        return n * per_layer + h
    if family == "bert":
        per_layer = 4 * (h * h + h) + (h * i + i) + (i * h + h) + 4 * h
        return n * per_layer + 2 * h
    raise ValueError(f"unknown family {family!r}")


def model_flops(model: dict, family: str, lengths) -> float:
    """FLOPs of one forward over sequences of these real lengths (specials
    included): 2 x non-embedding parameters a token, plus the attention
    products QK^T and PV at 2 FLOPs a multiply-add over the pairs each
    real token attends to (causal for qwen, all pairs for BERT)."""
    p = non_embedding_params(model, family)
    n = model["num_hidden_layers"]
    width = model["num_attention_heads"] * (model["head_dim"] if family == "qwen"
                                           else model["hidden_size"] // model["num_attention_heads"])
    total = 0.0
    for length in lengths:
        pairs = length * (length + 1) / 2 if family == "qwen" else length * length
        total += 2.0 * p * length + n * 4.0 * width * pairs
    return total


def mfu_percent(flops: float, seconds: float) -> float:
    return 100.0 * flops / (seconds * PEAK_OPS_S["bf16"])
