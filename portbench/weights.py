"""Random weights from the seed, made on the device in two calls: one
normal draw in bf16 for every matrix and embedding table (N(0, 0.02^2),
the published initializer range), one f32 draw for every norm gain
(1 + 0.1 N) and bias (0.02 N). Leaves are views into the two buffers,
laid out as the port's parameter dicts (`encoder/model.py`,
`encoder/bert.py`), which the reference reads as plain data."""

from __future__ import annotations

import torch


def _shapes(model: dict, family: str, max_seq: int):
    """(matrices, vectors): lists of (path, shape) of each kind."""
    h, i, n = model["hidden_size"], model["intermediate_size"], model["num_hidden_layers"]
    mats, vecs = [], []
    if family == "qwen":
        dh, nh, nk = model["head_dim"], model["num_attention_heads"], model["num_key_value_heads"]
        mats.append((("embed",), (model["vocab_size"], h)))
        vecs.append((("final_norm",), (h,)))
        for li in range(n):
            p = ("layers", li)
            mats += [(p + ("wq",), (h, nh * dh)), (p + ("wk",), (h, nk * dh)),
                     (p + ("wv",), (h, nk * dh)), (p + ("wo",), (nh * dh, h)),
                     (p + ("w_gate",), (h, i)), (p + ("w_up",), (h, i)), (p + ("w_down",), (i, h))]
            vecs += [(p + ("attn_norm",), (h,)), (p + ("mlp_norm",), (h,)),
                     (p + ("q_norm",), (dh,)), (p + ("k_norm",), (dh,))]
        return mats, vecs
    if family == "bert":
        mats += [(("embed",), (model["vocab_size"], h)), (("pos_embed",), (max_seq, h)),
                 (("type_embed",), (model["type_vocab_size"], h))]
        vecs += [(("embed_ln_g",), (h,)), (("embed_ln_b",), (h,))]
        for li in range(n):
            p = ("layers", li)
            mats += [(p + (w,), (h, h)) for w in ("wq", "wk", "wv", "wo")]
            mats += [(p + ("w_in",), (h, i)), (p + ("w_out",), (i, h))]
            vecs += [(p + (b,), (h,)) for b in ("bq", "bk", "bv", "bo", "b_out")]
            vecs += [(p + ("b_in",), (i,))]
            vecs += [(p + (g,), (h,)) for g in ("attn_ln_g", "attn_ln_b", "mlp_ln_g", "mlp_ln_b")]
        return mats, vecs
    raise ValueError(f"unknown family {family!r}")


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        if key == "layers":
            node = node.setdefault("layers", [])
        elif isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
    node[path[-1]] = value


def make_params(model: dict, family: str, max_seq: int, seed: int, device) -> dict:
    """The parameter dict of one tower, drawn from `seed` on `device`."""
    mats, vecs = _shapes(model, family, max_seq)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n_mat = sum(a * b for _, (a, b) in mats)
    n_vec = sum(s[0] for _, s in vecs)
    wbuf = torch.randn(n_mat, generator=gen, device=device, dtype=torch.bfloat16).mul_(0.02)
    vbuf = torch.randn(n_vec, generator=gen, device=device, dtype=torch.float32)
    params: dict = {}
    at = 0
    for path, (a, b) in mats:
        _put(params, path, wbuf[at : at + a * b].view(a, b))
        at += a * b
    at = 0
    for path, (a,) in vecs:
        v = vbuf[at : at + a]
        is_gain = path[-1].endswith(("norm", "_g"))
        _put(params, path, v.mul_(0.1).add_(1.0) if is_gain else v.mul_(0.02))
        at += a
    return params
