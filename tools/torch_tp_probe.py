#!/usr/bin/env python3
"""Where the tensor-parallel paths of the port lose accuracy and time, on
one card.

    python tools/torch_tp_probe.py [--parts cosine,cosine_f32,encode_batch,train_step]

Builds what `chip_smoke.py`'s phases mesh_encode_tp and mesh_train build,
from the same seeds and constants (`TP_TOWERS`, `MESH_TRAIN_CFG`), every
mesh on repeated entries of the one card, and prints one JSON line a
measurement:

- `cosine`: qwen's tp encode of the 4,096 slogans against one device,
  on 2 and 4 shards, as the port computes it (each shard's row-sharded
  partial product rounded to the activation dtype, then summed in f32)
  and with the partials kept in f32 (`TP.row` replaced for the run by an
  f32 product of the same bf16 values, TF32 off). If the rounding of the
  partials is what parts tp from one device, the f32 form closes the gap.
- `cosine_f32`: the same function computed in f32 throughout (params and
  activations f32, the reference composition, fused "off", TF32 off) on
  1,024 slogans, tp against one device on 2 and 4 shards: a tp forward
  that computes the one device's function agrees to f32 rounding (1 - cos
  near 1e-12); a fault in it (a head, a block, a sum misplaced) shows at
  any precision. Beside it, in bf16 on the same batches, one device's
  kernel path ("on") against its reference composition ("off"): how far
  two roundings of one function part at this depth.
- `encode_batch`: for each tower of `TP_TOWERS`, one batch of 512
  slogans through `BatchedEncoder.encode`, one device and tp: the wall
  time (median of 3), the host's share of it (tokenizing and padding,
  timed alone), the forward alone (`_forward` of the padded batch, synced),
  and from one `torch.profiler` run the kernels' summed device time, their
  number, and the device-busy share of the wall time.
- `train_step`: mesh_train's qwen step at 64 pairs x 64 tokens, one device
  and the (2, 2) mesh, fused "on": step ms (wall, synced, mean of 3 after
  2 warm steps), and from one profiled step the kernels' device time and
  number and the busy share of the step.

Needs one CUDA card (one stream: the kernels' summed time is the time
the card was busy).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _smoke():
    """`slogans` and the phases' constants from this checkout's chip_smoke.py."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="cosine,cosine_f32,encode_batch,train_step",
                    help="comma-separated measurements to make")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from theoremsearch_tpu_torch.core.config import (
        BertEncoderConfig, EncoderConfig, GemmaEncoderConfig, MeshConfig, TrainConfig,
    )
    from theoremsearch_tpu_torch.core.meshes import make_mesh
    from theoremsearch_tpu_torch.encoder import bert as bert_mod
    from theoremsearch_tpu_torch.encoder import gemma as gemma_mod
    from theoremsearch_tpu_torch.encoder import model as qwen_mod
    from theoremsearch_tpu_torch.encoder import sharding
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.tokenizer import SimpleTokenizer
    from theoremsearch_tpu_torch.train.contrastive import (
        init_train_state, make_train_step, shard_train_state,
    )
    from theoremsearch_tpu_torch.utils.device import gpu_name_power, require_cuda

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke()
    gpu = gpu_name_power()

    def emit(what, **kw):
        print(json.dumps({"what": what, **kw, "gpu": gpu}), flush=True)

    sync = torch.cuda.synchronize

    def device_time(fn):
        """(kernels' summed device ms, their number) over one call of fn."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
        return sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows)

    towers = smoke.TP_TOWERS
    family = {"qwen": (qwen_mod, EncoderConfig), "gemma": (gemma_mod, GemmaEncoderConfig),
              "bert": (bert_mod, BertEncoderConfig)}
    texts = smoke.slogans(4096)
    batch = 512

    def tower_params(name, overrides, seed):
        mod, cfg = family[name][0], family[name][1](**overrides)
        params = mod.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        if mod is gemma_mod:      # the (1 + w) norm weights off zero, as chip_smoke does
            gn = torch.Generator(device=dev).manual_seed(seed + 100)
            for layer in params["layers"]:
                for t in layer.values():
                    if t.ndim == 1:
                        t += 0.1 * torch.randn(t.shape, generator=gn, device=dev)
        return mod, cfg, params

    def cos_rows(a, b):
        c = np.sum(a.astype(np.float64) * b, axis=1)
        return float(c.min()), float(c.mean())

    def dist_max(a, b):
        """The largest row distance |a - b| of two sets of unit rows (finer
        than 1 - cos, which is half its square)."""
        return float(np.linalg.norm(a.astype(np.float64) - b, axis=1).max())

    # ---- the qwen tp encode's cosine: bf16 partials against f32 partials ----
    bf16_row = sharding.TP.row

    def f32_row(self, parts, w):
        acc = None
        for p, wp in zip(parts, w.pieces):
            part = torch.matmul(p.float(), wp.float()).to(self.first)
            acc = part if acc is None else acc + part
        return acc.to(parts[0].dtype)

    name, overrides, shards_q, seed = towers[0]
    mod, cfg, params = tower_params(name, overrides, seed)
    if "cosine" in parts:
        e_one = BatchedEncoder(params, cfg, batch_size=batch, device=dev).encode(texts)
        for shards in sorted({2, shards_q}):
            mesh = make_mesh(MeshConfig(data=1, shard=shards), devices=[dev] * shards)
            tp = BatchedEncoder(mod.shard_params(params, mesh), cfg, batch_size=batch, mesh=mesh)
            res = {}
            for form, row in (("bf16_partials", bf16_row), ("f32_partials", f32_row)):
                sharding.TP.row = row
                try:
                    res[form] = cos_rows(tp.encode(texts), e_one)
                finally:
                    sharding.TP.row = bf16_row
            emit("cosine", tower=name, shards=shards, texts=len(texts), layers=cfg.num_layers,
                 cos_min_mean={k: list(v) for k, v in res.items()})
            del tp
        del e_one

    if "cosine_f32" in parts:
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        p32 = {k: v.float() for k, v in params.items() if k != "layers"}
        p32["layers"] = [{k: v.float() for k, v in layer.items()} for layer in params["layers"]]
        tok = SimpleTokenizer(vocab_size=cfg.vocab_size)
        sub = texts[: len(texts) // 4]
        batches = []
        for start in range(0, len(sub), batch):
            enc = tok(sub[start:start + batch], max_length=64, pad_to=64)
            batches.append((torch.from_numpy(enc.input_ids).to(dev),
                            torch.from_numpy(enc.attention_mask).to(dev)))

        def pooled(prm, c, fused):
            with torch.inference_mode():
                return np.concatenate([mod.encode_pooled(prm, i, a, c, fused=fused).cpu().numpy()
                                       for i, a in batches])

        one32 = pooled(p32, cfg32, "off")
        res = {}
        for shards in sorted({2, shards_q}):
            mesh = make_mesh(MeshConfig(data=1, shard=shards), devices=[dev] * shards)
            tp32 = pooled(mod.shard_params(p32, mesh), cfg32, "off")
            res[shards] = {"cos_min_mean": list(cos_rows(tp32, one32)), "dist_max": dist_max(tp32, one32)}
        on, off = pooled(params, cfg, "on"), pooled(params, cfg, "off")
        emit("cosine_f32", tower=name, texts=len(sub), width=64, layers=cfg.num_layers,
             tp_vs_one_device_f32=res,
             one_device_bf16_on_vs_off={"cos_min_mean": list(cos_rows(on, off)),
                                        "dist_max": dist_max(on, off)})
        del p32, one32
    del params

    # ---- one encode batch of each tower: host, forward, device busy ----
    for name, overrides, shards, seed in towers if "encode_batch" in parts else ():
        mod, cfg, params = tower_params(name, overrides, seed)
        mesh = make_mesh(MeshConfig(data=1, shard=shards), devices=[dev] * shards)
        encs = {"one_device": BatchedEncoder(params, cfg, batch_size=batch, device=dev),
                "tp": BatchedEncoder(mod.shard_params(params, mesh), cfg, batch_size=batch, mesh=mesh)}
        part = texts[:batch]
        row = {}
        for key, enc in encs.items():
            enc.encode(part)                      # warm
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                enc.encode(part)
                walls.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            tokenized = [enc.tokenizer.tokenize(t) for t in part]
            ids_mask, _ = enc._prep_batch(part, tokenized, list(range(len(part))))
            host_ms = (time.perf_counter() - t0) * 1e3
            fwd = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                enc._forward(ids_mask)
                sync()
                fwd.append((time.perf_counter() - t0) * 1e3)
            kernel_ms, n_kernels = device_time(lambda: enc.encode(part))
            wall = statistics.median(walls)
            row[key] = {"wall_ms": wall, "host_prep_ms": host_ms, "forward_ms": statistics.median(fwd),
                        "kernel_ms": kernel_ms, "kernels": n_kernels,
                        "device_busy_share": kernel_ms / wall}
        emit("encode_batch", tower=name, shards=shards, batch=len(part), width=int(ids_mask.shape[-1]),
             **row)
        del params, encs
        torch.cuda.empty_cache()

    # ---- mesh_train's step: one device against the (2, 2) mesh ----
    if "train_step" not in parts:
        return 0
    cfg = EncoderConfig(**smoke.MESH_TRAIN_CFG)
    nb, seq = smoke.MESH_TRAIN_PAIRS[0], 64
    tc = TrainConfig(batch_size=nb, seq_len=seq, learning_rate=2e-5, temperature=0.05)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(3, cfg.vocab_size, (nb, seq)).astype(np.int32)).to(dev)
    p = torch.from_numpy(rng.integers(3, cfg.vocab_size, (nb, seq)).astype(np.int32)).to(dev)
    m = torch.ones((nb, seq), dtype=torch.int32, device=dev)
    one = init_train_state(cfg, tc, generator=torch.Generator(device=dev).manual_seed(71), device=dev)
    mesh = make_mesh(MeshConfig(data=2, shard=2), devices=[dev] * 4)
    states = {"one_device": (one, make_train_step(cfg, tc, fused="on")),
              "mesh": (shard_train_state(one, mesh, cfg), make_train_step(cfg, tc, mesh=mesh, fused="on"))}
    row = {}
    for key, (state, step) in states.items():
        for _ in range(2):
            state, _ = step(state, q, m, p, m)
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            state, loss = step(state, q, m, p, m)
        float(loss)
        step_ms = (time.perf_counter() - t0) * 1e3 / 3

        def one_step():
            nonlocal state
            state, _ = step(state, q, m, p, m)
        kernel_ms, n_kernels = device_time(one_step)
        row[key] = {"step_ms": step_ms, "kernel_ms": kernel_ms, "kernels": n_kernels,
                    "device_busy_share": kernel_ms / step_ms}
        states[key] = None
        del state
    emit("train_step", mesh_shape=[2, 2], batch_pairs=nb, seq_len=seq, layers=cfg.num_layers, **row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
