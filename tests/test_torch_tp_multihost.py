"""Port parity: tensor parallelism across processes (ROADMAP A.12), the
SPMD twin of the reference's GSPMD program on a mesh whose `shard` axis
spans processes.

Each layout runs once, in a module-scoped fixture: its processes
(tests/torch_multihost_worker.py, part `tp`, Gloo over a `file://`
rendezvous) join one group while this process computes the JAX
reference's mesh of the same shape on conftest's 8 CPU devices. The
three layouts start together and overlap. Both
start from the same numbers: the reference's params (and LoRA adapters)
carried over as files. Layouts:

- (1, 2) over two processes of one entry: qwen tiny head-local (kv 2 / 2);
- (1, 4) over two processes of two entries: qwen tiny and gemma tiny
  gathered, BERT tiny head-local (4 / 4), and the control runs;
- (2, 2) over four processes of one entry: qwen tiny, each data row over
  two processes, beside a sharded speed-path search.

In each: the tp encode, three dp + tp train steps and two LoRA steps,
held to each other across the processes and to the port's one-process
mesh of the same shape that process 0 runs itself (the f32 limits of
tests/test_torch_multihost.py); the encode and the train steps also to
the reference (tests/test_torch_tp_train.py's and
tests/test_torch_tp_encode.py's tolerances), whose LoRA mesh step
tests/test_torch_tp_train.py holds the one-process mesh to. The towers run in f32, where the one-process and
cross-process sums part by rounding only. The controls break one row
collective each (`torch_multihost_worker.tp_control`) and must miss a
gradient gate."""

import json
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import MeshConfig as JMeshConfig
from theoremsearch_tpu.core import make_mesh as j_make_mesh
from theoremsearch_tpu.core.config import BertEncoderConfig as JBertConfig
from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.core.config import GemmaEncoderConfig as JGemmaConfig
from theoremsearch_tpu.core.config import TrainConfig as JTrainConfig
from theoremsearch_tpu.encoder import bert as j_bert
from theoremsearch_tpu.encoder import gemma as j_gemma
from theoremsearch_tpu.encoder import model as j_model
from theoremsearch_tpu.encoder.batching import BatchedEncoder as JBatchedEncoder
from theoremsearch_tpu.train import contrastive as JC
from theoremsearch_tpu_torch.encoder.model import params_from_jax
from theoremsearch_tpu_torch.train.lora import lora_from_jax

import torch_multihost_worker as W
from test_torch_multihost import GRAD_NORM_REL_TOL, LOSS_TOL, PARAM_DISTANCE_REL_TOL
from torch_helpers import run_processes

torch.set_num_threads(1)

JAX_LOSS_TOL = 5e-3        # tests/test_torch_tp_train.py: a mesh step against the reference's
JAX_COS = 0.999            # tests/test_torch_tp_encode.py: the reference's own tp gate
ONE_PROCESS_COS = 0.9999   # tests/test_torch_tp_encode.py: against the port's one-process mesh
ZERO_GRAD_SHARE = 0.01     # the most of a tower's elements left out of the param distance
LR, TEMPERATURE, STEPS, LORA_STEPS = 1e-3, 0.2, 3, 2
JAX_TOWERS = {"tiny_f32": (j_model, JEncoderConfig), "gemma_tiny_f32": (j_gemma, JGemmaConfig),
              "bert_tiny_f32": (j_bert, JBertConfig)}
LAYOUTS = {
    "1x2": dict(mesh=(1, 2), world=2, local=1, towers=("tiny_f32",), checkpoint=True),
    "1x4": dict(mesh=(1, 4), world=2, local=2, towers=("tiny_f32", "gemma_tiny_f32", "bert_tiny_f32"),
                controls=("gemma_tiny_f32:gather_slice", "tiny_f32:bcast_no_sum",
                          "bert_tiny_f32:row_sum")),
    "2x2": dict(mesh=(2, 2), world=4, local=1, towers=("tiny_f32",), checkpoint=True, search=True),
}
# each control's tower, and the gradient gate it must miss
CONTROLS = {"gather_slice": "gemma_tiny_f32", "bcast_no_sum": "tiny_f32", "row_sum": "bert_tiny_f32"}


TCFG = JTrainConfig(batch_size=8, seq_len=16, learning_rate=LR, temperature=TEMPERATURE)
_PARAMS: dict = {}
_PARAMS_LOCK = threading.Lock()


def _jax_params(name: str):
    """(jmod, jcfg, numpy params, numpy LoRA adapters) of a tower, drawn
    once from PRNGKey(0) and PRNGKey(1) and shared by the layouts."""
    with _PARAMS_LOCK:
        if name not in _PARAMS:
            jmod, cls = JAX_TOWERS[name]
            jcfg = cls(**W.encoder_config(name).__dict__)
            params = jax.device_get(jmod.init_params(jcfg, jax.random.PRNGKey(0)))
            lora = JC.init_lora_train_state(params, TCFG.replace(lora_rank=4),
                                            jax.random.PRNGKey(1))
            _PARAMS[name] = (jmod, jcfg, params, jax.device_get(lora.params))
        return _PARAMS[name]


def _jax_setup(name: str, data: int, shard: int, tmp):
    """The tower's params and LoRA adapters written for the workers; the
    reference's sharded train state on a (data, shard) mesh beside them."""
    jmod, jcfg, params, adapters = _jax_params(name)
    torch.save(params_from_jax(params, device="cpu"), tmp / f"{name}.pt")
    torch.save(lora_from_jax(adapters, device="cpu"), tmp / f"{name}_lora.pt")
    jmesh = j_make_mesh(JMeshConfig(data=data, shard=shard))
    base = jmod.shard_params(params, jmesh)
    state = JC.TrainState(base, JC.make_optimizer(TCFG).init(base), jax.numpy.zeros((), "int32"))
    return jmod, jcfg, jmesh, state


def _jax_run(jmod, jcfg, jmesh, state) -> dict:
    """The reference on its mesh: the tp encode of the worker's texts and
    the losses of STEPS train steps on the worker's batches."""
    emb = JBatchedEncoder(state.params, jcfg, mesh=jmesh, batch_size=8,
                          buckets=(16,)).encode(W.ENCODE_TEXTS)
    batches = W.train_batches(STEPS, jcfg.vocab_size)
    out = {"encode": np.asarray(emb)}
    step = JC.make_train_step(jcfg, TCFG, mesh=jmesh)
    losses = []
    for b in batches:
        state, loss = step(state, *b)
        losses.append(float(loss))
    out["losses"] = losses
    return out


def _run_layout(name: str, tmp) -> dict:
    """One layout: the workers' results (in rank order) and the reference's
    per tower."""
    spec = LAYOUTS[name]
    data, shard = spec["mesh"]
    setups = {t: _jax_setup(t, data, shard, tmp) for t in spec["towers"]}
    args = ["--world", str(spec["world"]), "--init", f"file://{tmp}/rendezvous", "--device", "cpu",
            "--local", str(spec["local"]), "--workdir", str(tmp), "--parts",
            "search,tp" if spec.get("search") else "tp",
            "--tp-mesh", f"{data},{shard}", "--tp-towers", ",".join(spec["towers"]),
            "--tp-params-dir", str(tmp), "--train-steps", str(STEPS), "--lora-steps", str(LORA_STEPS),
            "--lr", str(LR), "--temperature", str(TEMPERATURE), "--check-one-process", "tp,search",
            "--search-mesh", f"{data},{shard}", "--n", "2048", "--d", "64"]
    if spec.get("checkpoint"):
        args.append("--tp-checkpoint")
    if spec.get("controls"):
        args += ["--tp-controls", ",".join(spec["controls"])]
    outs = [tmp / f"r{r}.json" for r in range(spec["world"])]
    failure = []

    def workers():
        try:
            run_processes([[W.__file__, "--rank", str(r), *args, "--out", str(outs[r])]
                           for r in range(spec["world"])], tmp, timeout=150)
        except BaseException as e:      # pytest.fail's exception, raised again below
            failure.append(e)

    th = threading.Thread(target=workers)
    th.start()
    try:
        # one thread a tower: XLA compiles the programs side by side
        with ThreadPoolExecutor(len(setups)) as pool:
            futures = {t: pool.submit(_jax_run, *s) for t, s in setups.items()}
            ref = {t: f.result() for t, f in futures.items()}
    finally:
        th.join()
    if failure:
        raise failure[0]
    return {"workers": [json.loads(o.read_text()) for o in outs], "jax": ref, "spec": spec}


@pytest.fixture(scope="module")
def _layouts(tmp_path_factory):
    """Every layout started at once, each in a thread of its own (their
    processes and the JAX side overlap); each layout's fixture waits for
    its own."""
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        yield {name: pool.submit(_run_layout, name, tmp_path_factory.mktemp(f"tp_{name}"))
               for name in LAYOUTS}


@pytest.fixture(scope="module")
def layout_1x2(_layouts):
    return _layouts["1x2"].result()


@pytest.fixture(scope="module")
def layout_1x4(_layouts):
    return _layouts["1x4"].result()


@pytest.fixture(scope="module")
def layout_2x2(_layouts):
    return _layouts["2x2"].result()


CASES = [(lay, t) for lay, spec in LAYOUTS.items() for t in spec["towers"]]


def _case(request, layout: str, tower: str):
    run = request.getfixturevalue(f"layout_{layout}")
    return run, [w["tp"]["towers"][tower] for w in run["workers"]], run["jax"][tower]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_places_each_process_on_its_row(request, layout):
    run = request.getfixturevalue(f"layout_{layout}")
    (data, shard), local = run["spec"]["mesh"], run["spec"]["local"]
    per_row = shard // local
    for r, w in enumerate(run["workers"]):
        tp = w["tp"]
        assert tp["layout"] == "shard" and tp["mesh"] == [data, shard]
        assert tp["local_rows"] == [r // per_row]
        assert tp["local_shards"] == [(r % per_row) * local + i for i in range(local)]
        assert tp["row_group_size"] == per_row and tp["column_group_size"] == data


@pytest.mark.parametrize("layout,tower", CASES)
def test_tp_encode_across_processes(request, layout, tower):
    """The same pooled rows on every process; against the port's
    one-process mesh (bit-equal where each row has two shards: one f32 sum
    of two partials is order-free), one device and the reference's mesh."""
    run, got, ref = _case(request, layout, tower)
    shas = {g["encode"]["sha256"] for g in got}
    assert len(shas) == 1
    e = got[0]["encode"]
    assert e["finite"] and e["shape"] == [len(W.ENCODE_TEXTS), ref["encode"].shape[1]]
    assert e["min_cos_vs_one_process"] >= ONE_PROCESS_COS
    assert e["min_cos_vs_one_device"] >= ONE_PROCESS_COS
    if run["spec"]["mesh"][1] == 2:
        assert e["equal_one_process"]
    emb = np.asarray(e["embeddings"], np.float32)
    assert W.min_cos(emb, ref["encode"]) >= JAX_COS
    # the forward's row sums are the only collectives of an encode
    assert set(e["collectives"]) <= {"all_reduce", "all_gather"}
    assert e["collectives"]["all_reduce"]["calls"] > 0


@pytest.mark.parametrize("layout,tower", CASES)
def test_train_across_processes(request, layout, tower):
    """Three dp + tp steps: the losses and the (gathered) params identical on
    every process; against the one-process mesh the readings within
    test_torch_multihost's limits; the losses within 5e-3 of the
    reference's mesh step."""
    run, got, ref = _case(request, layout, tower)
    t0 = got[0]["train"]
    assert all(g["train"]["losses"] == t0["losses"] for g in got)
    assert all(g["train"]["params_sha256"] == t0["params_sha256"] for g in got)
    assert all(np.isfinite(t0["losses"])) and len(t0["grad_norms"]) == STEPS
    r = t0["vs_one_process"]
    assert all(_gates(r).values()), r
    np.testing.assert_allclose(t0["losses"], ref["losses"], rtol=0, atol=JAX_LOSS_TOL)
    # every step sums over the row (forward partials, backward bcasts) and
    # gathers the clip's per-piece terms over it
    for c in t0["collectives_a_step"]:
        assert c["all_reduce"]["calls"] > 0 and c["all_gather"]["calls"] >= 1


@pytest.mark.parametrize("layout,tower", CASES)
def test_lora_across_processes(request, layout, tower):
    """Two LoRA steps over the frozen sharded base (the second loss reads
    the adapters' first update, whose gradient comes through each delta's
    blocks): the losses identical on every process and within
    test_torch_multihost's loss limit of the one-process mesh. (That
    mesh's LoRA step is held to the reference's `make_lora_train_step(mesh=)`
    by tests/test_torch_tp_train.py.)"""
    _, got, _ = _case(request, layout, tower)
    lo = got[0]["lora"]
    assert all(g["lora"]["losses"] == lo["losses"] for g in got)
    assert all(g["lora"]["adapters_sha256"] == lo["adapters_sha256"] for g in got)
    assert len(lo["losses"]) == LORA_STEPS and lo["losses"][1] != lo["losses"][0]
    assert lo["max_loss_delta"] <= LOSS_TOL


def _gates(r: dict) -> dict:
    """test_torch_multihost's limits. The param distance is taken over the leaves whose
    first gradient is not 0 to rounding (`torch_multihost_worker.tp_readings`):
    a leaf with an exact gradient of 0, as BERT's key bias, moves by
    rounding noise that AdamW turns into steps and that the row's other
    summation order changes. Those leaves must stay a small share."""
    return {"losses": r["max_loss_delta"] <= LOSS_TOL,
            "first_grad_norm": r["first_grad_norm_rel"] <= GRAD_NORM_REL_TOL,
            "grad_norms": r["max_grad_norm_rel"] <= GRAD_NORM_REL_TOL,
            "params": r["param_distance_rel_live"] <= PARAM_DISTANCE_REL_TOL,
            "zero_grad_share": r["zero_grad_share"] <= ZERO_GRAD_SHARE}


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_miss_a_gradient_gate(layout_1x4, control):
    """A broken row collective, run on the (1, 4) mesh: the gathered core's
    backward as a plain slice (GatherRows's), a `bcast` with no backward
    sum, a replicated leaf's gradient summed over the row as well. Each
    misses the gradient-norm gates against the one-process mesh, which the
    sound run holds."""
    tower = CONTROLS[control]
    c = layout_1x4["workers"][0]["tp"]["towers"][tower]["controls"][control]
    sound = _gates(layout_1x4["workers"][0]["tp"]["towers"][tower]["train"]["vs_one_process"])
    gates = _gates(c["vs_one_process"])
    assert all(sound.values())
    assert not gates["first_grad_norm"] and not gates["grad_norms"], c["vs_one_process"]


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_checkpoint_of_split_rows_restores_on_one_device(request, layout):
    """save_checkpoint of the trained state, its rows split over processes:
    every process joined the gather, process 0 wrote the file, and its
    one-device restore is bit-equal leaf for leaf (params, moments)."""
    run = request.getfixturevalue(f"layout_{layout}")
    ck = run["workers"][0]["tp"]["towers"]["tiny_f32"]["checkpoint"]
    assert ck["equal"] and ck["leaves"] > 0
    assert all("save_s" in w["tp"]["towers"]["tiny_f32"]["checkpoint"] for w in run["workers"])


def test_search_on_split_rows_equals_one_process(layout_2x2):
    """The speed path on the (2, 2) mesh: each data row's engine gathers its
    two shards' lists over its row group; every process returns the
    one-process (2, 2) engine's ids and scores."""
    res = [w["search"] for w in layout_2x2["workers"]]
    assert [s["local_rows"] for s in res] == [[0], [0], [1], [1]]
    assert [s["local_shards"] for s in res] == [[0], [1], [0], [1]]
    for s in res:
        assert s["equal_one_process"] and s["sharded_speed_ok"]
        assert s["ids"] == res[0]["ids"] and s["scores"] == res[0]["scores"]
        assert s["collectives"]["all_gather"]["calls"] == 1
