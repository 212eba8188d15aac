"""The port's training checkpoints, the `train` entry point and the eval
harness copy, on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from theoremsearch_tpu.eval.harness import evaluate_encoder_on_validation as j_evaluate
from theoremsearch_tpu_torch.core.config import EncoderConfig, TrainConfig
from theoremsearch_tpu_torch.eval.harness import evaluate_encoder_on_validation
from theoremsearch_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from theoremsearch_tpu_torch.train.contrastive import (
    init_lora_train_state,
    init_train_state,
    make_lora_train_step,
    make_train_step,
    tree_leaves,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CFG = EncoderConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
                    num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=64, embedding_dim=256)
TCFG = TrainConfig(batch_size=4, seq_len=16, learning_rate=1e-3, temperature=1.0, lora_rank=4)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1024, (2, 4, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < rng.integers(4, 17, 4)[:, None]).astype(np.int32)
    return ids[0], mask, ids[1], mask


def _equal_states(a, b):
    la, lb = tree_leaves(a.params), tree_leaves(b.params)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
    for ma, mb in ((a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu)):
        assert all(torch.equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(tree_leaves(ma), tree_leaves(mb)))
    assert a.step == b.step and a.opt_state.count == b.opt_state.count


def test_save_restore_roundtrip_then_resume(tmp_path):
    step = make_train_step(CFG, TCFG)
    state = init_train_state(CFG, TCFG, device="cpu")
    for i in range(2):
        state, _ = step(state, *_batch(i))
    save_checkpoint(state, tmp_path)
    assert latest_step(tmp_path) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2.npz"]
    template = init_train_state(CFG, TCFG, generator=torch.Generator().manual_seed(9), device="cpu")
    restored = restore_checkpoint(tmp_path, CFG, TCFG, template=template)
    _equal_states(state, restored)
    assert tree_leaves(restored.params)[0].dtype == torch.bfloat16
    # the resumed run continues with the very same loss
    state, l1 = step(state, *_batch(5))
    restored, l2 = step(restored, *_batch(5))
    assert float(l1) == float(l2)
    _equal_states(state, restored)


def test_restore_from_nothing_is_none(tmp_path):
    assert latest_step(tmp_path / "missing") is None
    assert restore_checkpoint(tmp_path / "missing", CFG, TCFG) is None
    assert restore_checkpoint(tmp_path, CFG, TCFG) is None


def test_lora_state_restores_with_its_template(tmp_path):
    base = init_train_state(CFG, TCFG, device="cpu").params
    state = init_lora_train_state(base, TCFG)
    step = make_lora_train_step(CFG, TCFG)
    for i in range(3):
        state, _ = step(state, base, *_batch(i))
    save_checkpoint(state, tmp_path)
    template = init_lora_train_state(base, TCFG, generator=torch.Generator().manual_seed(4))
    restored = restore_checkpoint(tmp_path, CFG, TCFG, template=template)
    _equal_states(state, restored)
    assert set(restored.params[1]) == {"wq", "wv"}
    assert restored.params[1]["wq"]["a"].dtype == torch.float32


def _cli(*args, cwd):
    return subprocess.run([sys.executable, "-m", "theoremsearch_tpu_torch", "train", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})


def test_cli_train_checkpoint_resume_and_refusals(tmp_path):
    ck = tmp_path / "ck"
    common = ["--device", "cpu", "--checkpoint-dir", str(ck), "--checkpoint-every", "2",
              "--batch-size", "8", "--log-every", "1"]
    r1 = _cli("--steps", "4", *common, cwd=tmp_path)
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert "[train] 65 pairs" in r1.stdout and "final loss" in r1.stdout
    assert latest_step(ck) == 4
    r2 = _cli("--steps", "6", "--eval", *common, cwd=tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed at step 4" in r2.stdout
    assert "[train] step 5:" in r2.stdout and "[train] after:" in r2.stdout
    final = float(r2.stdout.split("final loss ")[1].split()[0])
    assert np.isfinite(final) and latest_step(ck) == 6
    # --model-dir and --catalog are ported: a directory with no checkpoint
    # is refused, and an empty catalog adds no pairs
    r = _cli("--steps", "1", "--device", "cpu", "--model-dir", "x", cwd=tmp_path)
    assert r.returncode != 0 and "config.json" in r.stderr, r.stderr[-500:]
    r = _cli("--steps", "1", "--device", "cpu", "--catalog", "c.db", cwd=tmp_path)
    assert r.returncode == 0 and "[train] 65 pairs" in r.stdout, r.stderr[-500:]


@pytest.mark.parametrize("embedder", ["gemma", "bert"])
def test_cli_trains_the_other_towers(tmp_path, embedder):
    """`train --embedder gemma|bert` runs the family's tiny tower on the
    CPU, checkpoints and resumes."""
    ck = tmp_path / "ck"
    common = ["--embedder", embedder, "--device", "cpu", "--checkpoint-dir", str(ck),
              "--batch-size", "8", "--log-every", "1"]
    r1 = _cli("--steps", "2", *common, cwd=tmp_path)
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert latest_step(ck) == 2 and "final loss" in r1.stdout
    r2 = _cli("--steps", "3", *common, cwd=tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed at step 2" in r2.stdout and latest_step(ck) == 3
    assert np.isfinite(float(r2.stdout.split("final loss ")[1].split()[0]))


def _hash_encoder(texts):
    """A bag-of-words hashing encoder in numpy (the reference's own test
    encoder's kind): the same vectors on both sides."""
    out = np.zeros((len(texts), 64), np.float32)
    for i, t in enumerate(texts):
        for w in t.lower().split():
            out[i, sum(map(ord, w)) % 64] += 1.0
    return out


def test_harness_copy_matches_reference_on_validation_set():
    csv = ROOT / "data" / "validation_set.csv"
    if not csv.exists():
        pytest.skip("vendored validation_set.csv not available")
    mine = evaluate_encoder_on_validation(_hash_encoder, csv)
    ref = j_evaluate(_hash_encoder, csv)
    assert mine == ref and mine["num_queries"] == 65.0 and mine["H@5"] > 0
