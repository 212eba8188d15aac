"""Port parity: the run across processes, the twin of
tests/test_multihost.py.

Two port processes (tests/torch_multihost_worker.py, 4 "cpu" mesh entries
each) join one Gloo group through a `file://` rendezvous under the test's
temporary directory, so no two tests race for a port. The sharded speed
path runs on the global 8-shard mesh, whose per-shard top-k gather
crosses the process boundary; live updates with compact(reclaim=True),
the masked, grouped, exact, residual and IVF routes, the dp + tp train
step on a (data 2, shard 4) mesh whose gradient sums cross it, LoRA
steps over its frozen base, and a dp encode run beside it. The test holds the workers to each other, to the
JAX single-device engines (Pallas in interpret mode, as the reference's
test runs them), and to the port's one-process meshes of the same shape,
built here from the worker module's own functions. The train step's
readings against the one-process mesh (`train_readings`) are also shown
to catch a gradient sum broken on purpose (`train_control`)."""

import json

import jax
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import IndexConfig as JIndexConfig
from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.encoder.batching import BatchedEncoder as JBatchedEncoder
from theoremsearch_tpu.encoder.model import init_params as j_init_params
from theoremsearch_tpu.index import FlatIndex as JFlatIndex
from theoremsearch_tpu.search import SearchEngine as JSearchEngine
from theoremsearch_tpu_torch.core.config import TrainConfig
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder.model import params_from_jax
from theoremsearch_tpu_torch.index.ivf import IVFIndex

import torch_multihost_worker as W
from torch_helpers import cpu_mesh, run_processes, serialize_reference_native

# the train step's limits against the one-process (2, 4) mesh, in f32 on
# the CPU: the sound run reads a loss difference of 1.2e-7, gradient norms
# 0 (first step) and 1.0e-5 (largest) apart and a param distance of
# 5.4e-6 of the update; twice the sum reads 1.0, 1.0 and 4.2e-3 (its
# losses equal the sound run's: AdamW does not see a gradient's scale),
# no sum 0.37, 0.99 and 1.16
LOSS_TOL, GRAD_NORM_REL_TOL, PARAM_DISTANCE_REL_TOL = 1e-5, 1e-3, 1e-4

torch.set_num_threads(2)
serialize_reference_native()

WORKER = W.__file__
ARGS = W.parse(["--rank", "0", "--world", "1", "--init", "-", "--out", "-"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both workers' results, the JAX tiny params they encoded with, and
    the directory holding rank 0's IVF index."""
    tmp = tmp_path_factory.mktemp("multihost")
    jparams = j_init_params(JEncoderConfig.tiny(), jax.random.PRNGKey(0))
    torch.save(params_from_jax(jax.device_get(jparams), device="cpu"), tmp / "params.pt")
    outs = [tmp / f"proc{r}.json" for r in range(2)]
    run_processes([[WORKER, "--rank", str(r), "--world", "2", "--init", f"file://{tmp}/rendezvous",
                    "--device", "cpu", "--out", str(outs[r]), "--workdir", str(tmp),
                    "--encode-params", str(tmp / "params.pt"), "--lora-steps", "2",
                    "--check-one-process", "train"]
                   for r in range(2)], tmp, timeout=180)
    return [json.loads(o.read_text()) for o in outs], jparams, tmp


def _jax_engine(vecs):
    idx = JFlatIndex.build(vecs, ids=np.arange(vecs.shape[0]),
                           config=JIndexConfig(dtype="int8", int8_scale="global"))
    return JSearchEngine(idx, use_pallas=True, pallas_interpret=True, row_block=128,
                         rescore_vectors=vecs, rescore_factor=8)


def test_speed_path_across_processes_equals_jax_single_device(run):
    results, _, _ = run
    for r in results:
        assert r["world"] == 2 and r["backend"] == "gloo"
        s = r["search"]
        assert s["n_global_shards"] == 8 and s["layout"] == "shard"
        assert s["sharded_speed_ok"], "speed path must be active on the global mesh"
        assert s["local_shards"] == list(range(4 * r["rank"], 4 * r["rank"] + 4))
        assert s["collectives"]["all_gather"]["calls"] == 1   # one gather a batch
    assert results[0]["search"]["ids"] == results[1]["search"]["ids"]
    assert results[0]["search"]["scores"] == results[1]["search"]["scores"]
    vecs, queries = W.corpus(ARGS.n, ARGS.d, ARGS.batch, "cpu")
    _, ref_ids = _jax_engine(vecs).search_vectors(queries, k=10)
    assert results[0]["search"]["ids"] == np.asarray(ref_ids).tolist()
    # bit-equal to the port's one-process mesh of the same 8 shards
    one = W.flat_engine(vecs, cpu_mesh(8), "cpu", ARGS)
    assert W.search_lists(one, queries, 10) == {k: results[0]["search"][k] for k in ("ids", "scores")}


def test_live_updates_across_processes_equal_jax_single_device(run):
    results, _, _ = run
    keys = ("live_ids", "post_reclaim_ids", "folded", "num_live", "live_scores",
            "post_reclaim_scores")
    for key in keys:
        assert results[0]["live"][key] == results[1]["live"][key], key
    live = results[0]["live"]
    assert live["deleted"] == 2 and not live["deleted_returned"]
    vecs, queries = W.corpus(ARGS.n, ARGS.d, ARGS.batch, "cpu")
    eng = _jax_engine(vecs)
    new, main_del, n_new = W.live_stream(ARGS.n, ARGS.d, ARGS.live_adds, ARGS.live_deletes)
    ids_new = eng.add_documents(new[:5], normalize=False)
    eng.update_document(17, new[5])
    assert eng.delete_documents(main_del + [int(x) for x in ids_new[:n_new]]) == 2
    _, i_live = eng.search_vectors(queries, k=10)
    folded = eng.compact(reclaim=True)
    _, i_post = eng.search_vectors(queries, k=10)
    assert live["live_ids"] == np.asarray(i_live).tolist()
    assert live["post_reclaim_ids"] == np.asarray(i_post).tolist()
    assert live["folded"] == folded and live["num_live"] == eng.num_live


def test_routes_across_processes_equal_one_process_mesh(run):
    """The masked, grouped, exact and residual routes and the list-sharded
    IVF searcher equal the port's one-process 8-shard mesh id for id
    (scores too), over the IVF index rank 0 saved."""
    results, _, tmp = run
    vecs, queries = W.corpus(ARGS.n, ARGS.d, ARGS.batch, "cpu")
    want = W.route_results(vecs, queries, cpu_mesh(8), "cpu", ARGS,
                           IVFIndex.load(tmp / "ivf", device="cpu"))
    for r in results:
        got = r["routes"]
        assert got["route_counts"] == {"masked": 1, "grouped": 1}
        for route in ("masked", "grouped", "exact", "residual", "ivf"):
            assert got[route] == want[route], route


def test_train_across_processes_matches_one_process_mesh(run):
    results, _, _ = run
    t0, t1 = results[0]["train"], results[1]["train"]
    assert t0["layout"] == "data" and t0["local_rows"] == [0] and t1["local_rows"] == [1]
    # the loss is replicated across the process boundary, finite, falling
    assert t0["losses"] == t1["losses"]
    assert all(np.isfinite(t0["losses"])) and t0["losses"][-1] < t0["losses"][0]
    # the params stay bit-identical across processes
    assert t0["params_sha256"] == t1["params_sha256"]
    # one flat all-reduce a dtype a step (f32 here), the rows gathered
    # twice a step (queries and positives)
    for step in t0["collectives_a_step"]:
        assert step["all_reduce"]["calls"] == 1 and step["all_gather"]["calls"] == 2
    cfg = W.encoder_config("tiny_f32")
    batches = W.train_batches(3, cfg.vocab_size)
    tcfg = TrainConfig(batch_size=8, seq_len=16, learning_rate=3e-3)
    one = W.train_run(cfg, tcfg, cpu_mesh(4, data=2), batches, 0, "on", "cpu")
    np.testing.assert_allclose(t0["losses"], one["losses"], atol=LOSS_TOL, rtol=0)


def _train_gates(t: dict) -> dict:
    r = t["vs_one_process"]
    return {"first_loss_equal": r["first_loss_equal"], "losses": r["max_loss_delta"] <= LOSS_TOL,
            "first_grad_norm": r["first_grad_norm_rel"] <= GRAD_NORM_REL_TOL,
            "grad_norms": r["max_grad_norm_rel"] <= GRAD_NORM_REL_TOL,
            "params": r["param_distance_rel"] <= PARAM_DISTANCE_REL_TOL}


def test_train_readings_hold_the_one_process_mesh(run):
    """Process 0's trajectory against the one-process (2, 4) mesh it ran
    itself: the first loss equal, the losses, the gradient norms each
    update read and the final params within the limits; on both
    processes the sum over the group of a bf16 tensor of the gradients'
    size is the f32 sum of the gathered tensors cast back, bit for bit."""
    results, _, _ = run
    t0 = results[0]["train"]
    assert t0["control"] == "sum" and len(t0["grad_norms"]) == 3
    assert all(_train_gates(t0).values()), t0["vs_one_process"]
    for r in results:
        assert r["train"]["staged_sum"]["bit_equal"]
        assert r["train"]["staged_sum"]["numel"] == t0["numel"]


@pytest.mark.parametrize("control, missed", [
    ("doubled_sum", {"first_grad_norm", "grad_norms", "params"}),
    ("no_sum", {"losses", "first_grad_norm", "grad_norms", "params"}),
])
def test_train_readings_catch_a_broken_gradient_sum(tmp_path, control, missed):
    """The same workers with the sum over processes broken on purpose: a
    doubled sum (losses unchanged, since AdamW does not see a gradient's
    scale) or none at all. The readings against the one-process mesh
    miss their limits."""
    res = W.run_workers([["--rank", str(r), "--world", "2", "--init",
                          f"file://{tmp_path}/rendezvous", "--device", "cpu", "--parts", "train",
                          "--train-control", control, "--check-one-process", "train"]
                         for r in range(2)], str(tmp_path), timeout=180)
    t0 = res[0]["train"]
    assert t0["control"] == control and t0["vs_one_process"]["first_loss_equal"]
    gates = _train_gates(t0)
    assert {k for k, ok in gates.items() if not ok} == missed, t0["vs_one_process"]
    if control == "no_sum":      # each process kept its own gradient
        assert res[1]["train"]["params_sha256"] != t0["params_sha256"]


def test_lora_across_processes_matches_one_process_mesh(run):
    """make_lora_train_step(mesh=) over the frozen sharded base: the adapter
    gradients summed over the processes, the adapters identical on both."""
    results, _, _ = run
    l0, l1 = results[0]["train"]["lora"], results[1]["train"]["lora"]
    assert l0["losses"] == l1["losses"] and all(np.isfinite(l0["losses"]))
    assert l0["adapters_sha256"] == l1["adapters_sha256"]
    cfg = W.encoder_config("tiny_f32")
    tcfg = TrainConfig(batch_size=8, seq_len=16, learning_rate=3e-3)
    one = W.lora_run(cfg, tcfg, cpu_mesh(4, data=2), W.train_batches(2, cfg.vocab_size), 0, "on")
    np.testing.assert_allclose(l0["losses"], one["losses"], atol=1e-5, rtol=0)
    assert l0["losses"][1] != l0["losses"][0]       # the adapters moved


def test_dp_encode_across_processes(run):
    results, jparams, tmp = run
    texts = W.ENCODE_TEXTS
    jcfg = JEncoderConfig.tiny()
    e_jax = np.asarray(JBatchedEncoder(jparams, jcfg, batch_size=8, buckets=(16,)).encode(texts))
    cfg = W.encoder_config("tiny")
    e_one = BatchedEncoder(torch.load(tmp / "params.pt", weights_only=True), cfg, batch_size=8,
                           buckets=(16,), device="cpu").encode(texts)
    for r in results:
        enc = r["encode"]
        assert enc["shape"] == [8, cfg.embedding_dim] and enc["finite"]
        e = np.asarray(enc["embeddings"], np.float32)
        assert float(np.min(np.sum(e * e_jax, axis=1))) > 0.999
        assert float(np.min(np.sum(e * e_one, axis=1))) >= 0.9999
        assert enc["min_cos_vs_one_device"] >= 0.9999
        assert enc["collectives"]["all_gather"]["calls"] == 1
    assert results[0]["encode"]["sha256"] == results[1]["encode"]["sha256"]
