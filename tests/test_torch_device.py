"""The port's device rules: entry points run on the card unless the
caller passes a device (no quiet CPU fallback), and the TF32 guard holds
TF32 off for every thread inside it, however the threads overlap."""

import threading

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.cli import main as cli_main
from theoremsearch_tpu_torch.core.config import (
    BertEncoderConfig,
    EncoderConfig,
    GemmaEncoderConfig,
    TrainConfig,
)
from theoremsearch_tpu_torch.encoder import bert, gemma, loader
from theoremsearch_tpu_torch.encoder.model import init_params, params_from_jax
from theoremsearch_tpu_torch.eval.harness import recall_gate
from theoremsearch_tpu_torch.eval.oracle import exact_topk
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.ivf import IVFIndex
from theoremsearch_tpu_torch.train.contrastive import (
    init_train_state,
    make_train_step,
    train_state_from_jax,
)
from theoremsearch_tpu_torch.utils.device import require_cuda, resolve_device, tf32_off


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["require_cuda", "resolve_device", "init_params", "params_from_jax",
                                   "FlatIndex.build", "exact_topk", "IVFIndex.build",
                                   "init_train_state", "train_state_from_jax", "train --device",
                                   "gemma.init_params", "bert.init_params",
                                   "load_hf_gemma_checkpoint", "load_hf_bert_checkpoint",
                                   "init_train_state gemma", "train --embedder bert",
                                   "recall_gate"])
def test_entry_points_default_to_the_card(no_cuda, entry):
    call = {
        "require_cuda": require_cuda,
        "resolve_device": lambda: resolve_device(None),
        "init_params": lambda: init_params(EncoderConfig.tiny(), torch.Generator()),
        "params_from_jax": lambda: params_from_jax({"w": np.zeros((2, 2), np.float32)}),
        "FlatIndex.build": lambda: FlatIndex.build(np.ones((4, 8), np.float32)),
        "exact_topk": lambda: exact_topk(np.ones((2, 8), np.float32), np.ones((4, 8), np.float32)),
        "IVFIndex.build": lambda: IVFIndex.build(np.ones((4, 8), np.float32)),
        "init_train_state": lambda: init_train_state(EncoderConfig.tiny(), TrainConfig()),
        "train_state_from_jax": lambda: train_state_from_jax(None),
        "train --device": lambda: cli_main(["train", "--steps", "1"]),
        "gemma.init_params": lambda: gemma.init_params(GemmaEncoderConfig.tiny(), torch.Generator()),
        "bert.init_params": lambda: bert.init_params(BertEncoderConfig.tiny(), torch.Generator()),
        "load_hf_gemma_checkpoint": lambda: loader.load_hf_gemma_checkpoint("no_such_dir"),
        "load_hf_bert_checkpoint": lambda: loader.load_hf_bert_checkpoint("no_such_dir"),
        "init_train_state gemma": lambda: init_train_state(GemmaEncoderConfig.tiny(), TrainConfig()),
        "train --embedder bert": lambda: cli_main(["train", "--steps", "1", "--embedder", "bert"]),
        # a kept difference: the verbatim harness calls exact_topk with no
        # device, which is the card in the port (any backend in the
        # reference); tests/test_torch_cuda.py runs it there
        "recall_gate": lambda: recall_gate(np.ones((2, 8), np.float32), np.ones((4, 8), np.float32),
                                           np.zeros((2, 10), np.int64)),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_train_step_runs_where_its_state_lives():
    """make_train_step follows its state's device: a CPU state trains on
    the CPU when asked for, and the loss stays a 0-d tensor there."""
    cfg = EncoderConfig.tiny()
    state = init_train_state(cfg, TrainConfig(), device="cpu")
    ids = np.random.default_rng(0).integers(3, 1024, (2, 4, 8)).astype(np.int32)
    mask = np.ones((4, 8), np.int32)
    state, loss = make_train_step(cfg, TrainConfig())(state, ids[0], mask, ids[1], mask)
    assert loss.device.type == "cpu" and loss.dim() == 0 and state.step == 1
    assert state.params["embed"].device.type == "cpu" and not state.params["embed"].requires_grad


def test_cpu_on_request():
    assert resolve_device("cpu") == torch.device("cpu")
    p = params_from_jax({"w": np.ones((2, 2), np.float32), "l": [np.zeros(3, np.float32)]},
                        device="cpu")
    assert p["w"].device.type == "cpu" and p["l"][0].shape == (3,)


@pytest.fixture
def tf32_on():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def test_tf32_guard_overlapping_threads(tf32_on):
    """A enters, B enters, A leaves while B is still inside, B checks the
    flags, B leaves: TF32 stays off for B and comes back after both."""
    a_in, a_out, b_in = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with tf32_off():
            a_in.set()
            b_in.wait(10)
            seen["a_mid"] = _flags()
        a_out.set()

    def b():
        a_in.wait(10)
        with tf32_off():
            b_in.set()
            a_out.wait(10)
            seen["b_mid"] = _flags()     # A has left; B is still inside

    ts = [threading.Thread(target=f) for f in (a, b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)
    assert seen == {"a_mid": (False, False), "b_mid": (False, False)}
    assert _flags() == (True, True)


def test_tf32_guard_nested_and_on_error(tf32_on):
    with pytest.raises(ValueError):
        with tf32_off():
            with tf32_off():
                assert _flags() == (False, False)
            assert _flags() == (False, False)
            raise ValueError
    assert _flags() == (True, True)
