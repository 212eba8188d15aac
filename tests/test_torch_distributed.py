"""The port's process-group layer (`core/distributed.py`) and the mesh
across processes (`core/meshes.py`): the layout rule, the refusals, and
the collectives over Gloo at world size 2.

Everything that opens a process group runs in two subprocesses of this
file (`python tests/test_torch_distributed.py RANK WORLD INIT OUT`), so
no pytest worker keeps a group's global state; the tests read their JSON.
This file imports no jax."""

import json
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.core import distributed
from theoremsearch_tpu_torch.core.config import EncoderConfig, MeshConfig, TrainConfig
from theoremsearch_tpu_torch.core.distributed import ProcessGroup, process_layout
from theoremsearch_tpu_torch.core.meshes import Mesh, make_mesh, mesh_groups

# ---------------------------------------------------------------- plain rules


@pytest.mark.parametrize("data, shard, n_local, n_proc, want", [
    (1, 8, 4, 2, "shard"),     # (a) the reference's search mesh over two hosts
    (1, 4, 2, 2, "shard"),     # (a) chip_smoke's Gloo pair: 2 shards a process
    (1, 8, 2, 4, "shard"),
    (2, 4, 4, 2, "data"),      # (b) MeshConfig(data=2, shard=4) over two hosts
    (2, 2, 2, 2, "data"),      # (b) one data row a process
    (4, 1, 2, 2, "data"),      # (b) two data rows a process (the dp encode)
    (4, 2, 4, 2, "data"),
    (2, 4, 8, 1, "local"),
    (2, 2, 4, 1, "local"),     # the NCCL world-1 run
    (2, 4, 2, 4, "shard"),     # (c) two data rows, each split over two processes (tp across them)
])
def test_process_layout_accepts_the_two_layouts(data, shard, n_local, n_proc, want):
    assert process_layout(data, shard, n_local, n_proc) == want


@pytest.mark.parametrize("data, shard, n_local, n_proc, match", [
    (2, 3, 2, 3, "unevenly"),          # a block straddles two data rows
    (2, 6, 4, 3, "unevenly"),
    (3, 2, 3, 2, "unevenly"),
    (2, 4, 4, 3, "needs 8 devices"),
    (0, 4, 4, 1, "positive"),
])
def test_process_layout_refuses_other_splits(data, shard, n_local, n_proc, match):
    with pytest.raises(ValueError, match=match):
        process_layout(data, shard, n_local, n_proc)


def _spanning_mesh(data, shard, n_local, rank, world) -> Mesh:
    """The mesh `make_mesh` builds on process `rank` of `world`, made here
    without a group (the layout logic alone)."""
    pg = ProcessGroup(None, rank, world, "gloo", torch.device("cpu"), 300.0)
    layout = process_layout(data, shard, n_local, world)
    grid = np.empty(data * shard, dtype=object)
    local = np.zeros(data * shard, bool)
    grid[rank * n_local : (rank + 1) * n_local] = [torch.device("cpu")] * n_local
    local[rank * n_local : (rank + 1) * n_local] = True
    row, col = mesh_groups(layout, data, shard, n_local, pg)
    return Mesh(grid.reshape(data, shard), process_group=pg, local=local.reshape(data, shard),
                layout=layout, row_group=row, column_group=col)


def test_mesh_positions_of_each_layout():
    a = _spanning_mesh(1, 8, 4, 1, 2)
    assert a.home_row == 0 and a.local_rows == [0] and not a.local[0].all()
    assert [s for s, _ in a.local_shards] == [4, 5, 6, 7] and len(a.shard_devices) == 4
    assert a.row_group is a.process_group and a.column_group is None
    b = _spanning_mesh(2, 4, 4, 1, 2)
    assert b.home_row == 1 and b.local_rows == [1] and b.data_devices == [torch.device("cpu")]
    assert [s for s, _ in b.local_shards] == [0, 1, 2, 3] and len(b.shard_devices) == 4
    assert b.column_group is b.process_group and b.row_group is None and b.local[1].all()
    one = make_mesh(MeshConfig(data=2, shard=2), devices=["cpu"] * 4)
    assert one.process_group is None and one.layout == "local" and one.local_rows == [0, 1]
    assert one.row_group is None and one.column_group is None
    with pytest.raises(RuntimeError, match="call initialize"):
        _spanning_mesh(2, 4, 2, 1, 4)       # a split row at data > 1 needs real subgroups


def test_tensor_parallel_across_processes_raises():
    """Params whose shard axis crosses a process boundary (a data row that
    spans processes) are placed: each process keeps its own block of
    pieces with their global indices, the logical shape stays global, and
    a moment split as the leaf keeps the same block. Nothing here raises
    any more (ROADMAP A.12 is ported); tests/test_torch_tp_multihost.py
    runs the collectives."""
    from theoremsearch_tpu_torch.encoder.model import init_params, shard_params
    from theoremsearch_tpu_torch.encoder.sharding import ShardedTensor

    cfg = EncoderConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for rank in range(2):
        mesh = _spanning_mesh(1, 8, 4, rank, 2)
        assert mesh.shard_devices == [torch.device("cpu")] * 4
        placed = shard_params(params, mesh)
        wq = placed["layers"][0]["wq"]
        assert isinstance(wq, ShardedTensor) and wq.split_over_processes
        assert wq.index == [4 * rank + i for i in range(4)] and wq.count == 8
        assert tuple(wq.shape) == tuple(params["layers"][0]["wq"].shape)
        want = torch.tensor_split(params["layers"][0]["wq"], 8, dim=1)[4 * rank : 4 * rank + 4]
        assert all(torch.equal(p, w) for p, w in zip(wq.pieces, want))
        emb = placed["embed"]
        assert emb.index[0] == 4 * rank and emb.pieces[0].shape[0] == cfg.vocab_size // 8
        mu = wq.split(torch.arange(wq.shape.numel(), dtype=torch.float32).view(wq.shape))
        assert mu.index == wq.index and [tuple(p.shape) for p in mu.pieces] == \
            [tuple(p.shape) for p in wq.pieces]
        assert torch.equal(mu.pieces[0][0], torch.arange(wq.shape[1])[16 * 4 * rank:][:16].float())
        assert not isinstance(placed["final_norm"], ShardedTensor)


def test_initialize_needs_a_device_or_cuda():
    assert distributed.current() is None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        distributed.initialize("file:///nonexistent", 2, 0)
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        distributed.initialize("file:///nonexistent", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend must be"):
        distributed.initialize("file:///nonexistent", 2, 0, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="outside a world"):
        distributed.initialize("file:///nonexistent", 2, 2, device="cpu")
    assert distributed.current() is None


def test_make_mesh_without_a_group_is_unchanged():
    m = make_mesh(MeshConfig(data=2, shard=4), devices=["cpu"] * 8)
    assert m.process_count == 1 and m.process_index == 0 and m.local.all()
    assert m.first_device == torch.device("cpu") and m.home_row == 0


def _nccl_group(world: int = 2) -> ProcessGroup:
    """An NCCL group's record, never opened: for the checks that run before
    a collective reaches the backend."""
    return ProcessGroup(None, 0, world, "nccl", torch.device("cuda", 0), 300.0)


@pytest.mark.parametrize("op", ["all_gather", "all_reduce_sum", "broadcast"])
def test_nccl_group_refuses_a_host_tensor(op):
    """NCCL has no host transport: a collective given a CPU tensor on an
    NCCL group raises naming the tensor's device, before the backend."""
    args = {"broadcast": (0,)}.get(op, ())
    with pytest.raises(ValueError, match="NCCL group takes CUDA tensors, got one on cpu"):
        getattr(distributed, op)(torch.zeros(4), *args, _nccl_group())


def test_split_leaf_save_hands_no_host_tensor_to_a_collective(tmp_path, monkeypatch):
    """save_checkpoint of a leaf whose row is split over processes gathers
    the pieces on their own device and copies the result to the host
    afterwards: the collective never sees a host tensor, which an NCCL
    group refuses. The pieces lie on the meta device, standing for the
    card; the gather is recorded and answers with the row's pieces."""
    from theoremsearch_tpu_torch.encoder import sharding
    from theoremsearch_tpu_torch.encoder.sharding import ShardedTensor
    from theoremsearch_tpu_torch.train.checkpoint import save_checkpoint
    from theoremsearch_tpu_torch.train.contrastive import AdamWState, TrainState

    seen = []

    def gather(t, pg):
        seen.append(t.device)
        return [torch.full(t.shape, float(r), dtype=t.dtype) for r in range(pg.size)]

    monkeypatch.setattr(sharding, "all_gather", gather)
    mesh = type("RowMesh", (), {"row_group": _nccl_group()})()

    def leaf():
        return ShardedTensor([torch.empty((3, 2), device="meta")] * 2, 1, mesh, [0, 1], 4)

    state = TrainState({"w": leaf()}, AdamWState(1, {"w": leaf()}, {"w": leaf()}), 1)
    save_checkpoint(state, tmp_path)
    assert seen == [torch.device("meta")] * 3
    w = np.load(tmp_path / "step_1.npz")["leaf_0"]
    assert w.shape == (3, 8) and (w[:, 4:] == 1).all()


def test_subgroups_keep_the_groups_timeout(monkeypatch):
    """A row or column group waits for a peer as long as the group
    `initialize` opened (its timeout_s), not the backend's default."""
    calls = []

    def new_group(ranks, **kw):
        calls.append((tuple(ranks), kw))
        return object()

    monkeypatch.setattr(distributed.dist, "new_group", new_group)
    monkeypatch.setattr(distributed, "_current",
                        ProcessGroup(None, 2, 4, "gloo", torch.device("cpu"), 7.5))
    monkeypatch.setattr(distributed, "_subgroups", {})
    row, col = mesh_groups("shard", 2, 2, 1, distributed.current())
    assert [r for r, _ in calls] == [(0, 1), (2, 3), (0, 2), (1, 3)]
    assert all(kw["timeout"] == timedelta(seconds=7.5) for _, kw in calls)
    assert (row.rank, row.size, row.timeout_s) == (0, 2, 7.5)
    assert (col.rank, col.size, col.timeout_s) == (1, 2, 7.5)


# ---------------------------------------------------------------- two processes


class ReduceScatterGather(torch.autograd.Function):
    """The gather with the backward of torch.distributed.nn's all_gather:
    the upstream gradients summed over the processes, then this process's
    slice. With a loss every process computes alike, it counts each
    gradient world-size times; the test shows that it fails."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg, ctx.lo, ctx.n = pg, pg.rank * x.shape[0], x.shape[0]
        return torch.cat(distributed.all_gather(x, pg))

    @staticmethod
    def backward(ctx, g):
        return distributed.all_reduce_sum(g, ctx.pg).narrow(0, ctx.lo, ctx.n), None


def _rows(rank: int) -> torch.Tensor:
    return torch.randn((3, 5), generator=torch.Generator().manual_seed(10 + rank))


def _loss(y: torch.Tensor) -> torch.Tensor:
    w = torch.linspace(-1.0, 1.0, y.shape[0])[:, None]
    return ((y * w).sum(0) ** 2).sum() + (y ** 3).sum()


def _negatives_grads(cfg, params, mesh) -> list:
    """The logical gradients of one InfoNCE loss with explicit hard
    negatives on `mesh` (summed over its processes when it spans them)."""
    from theoremsearch_tpu_torch.encoder.tokenizer import SimpleTokenizer
    from theoremsearch_tpu_torch.train.contrastive import info_nce_loss, logical_grads, piece_leaves

    tok = SimpleTokenizer(vocab_size=cfg.vocab_size)
    q, p, n = (tok([f"{w} {i}" for i in range(m)], pad_to=16)
               for w, m in (("query", 4), ("positive", 4), ("negative", 3)))
    t = [torch.from_numpy(x) for e in (q, p, n) for x in (e.input_ids, e.attention_mask)]
    leaves = piece_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = info_nce_loss(params, *t[:4], cfg, 0.05, "on", *t[4:], mesh=mesh)
    grads = list(torch.autograd.grad(loss, leaves))
    for x in leaves:
        x.requires_grad_(False)
    if mesh.column_group is not None:
        grads = distributed.all_reduce_flat(grads, mesh.column_group)
    return [g.detach() for g in logical_grads(params, grads)]


def _tp_mini(mesh) -> dict:
    """A small tensor-parallel chain in f64 over `mesh`'s shard axis that
    runs each collective of `encoder/sharding.py:TP` once: a vocab-sharded
    lookup (`embed`), a replicated input read by every shard (`bcast`),
    column blocks gathered and mixed across blocks as a gathered attention
    core mixes them (`gather`, `scatter`), a row-sharded product summed
    over the shards (`row`). Returns the loss and the gradients of the
    replicated input and of this process's pieces, by global piece."""
    from theoremsearch_tpu_torch.encoder.sharding import TP, place_params

    gen = torch.Generator().manual_seed(3)
    full = {"embed": torch.randn((16, 6), generator=gen, dtype=torch.float64),
            "wcol": torch.randn((6, 8), generator=gen, dtype=torch.float64),
            "wrow": torch.randn((8, 6), generator=gen, dtype=torch.float64), "layers": []}
    rules = {"embed": ("shard", None), "wcol": (None, "shard"), "wrow": ("shard", None), "layers": {}}
    p = place_params(full, rules, mesh)
    x = torch.randn((3, 6), generator=gen, dtype=torch.float64)
    ids = torch.tensor([1, 7, 14])
    leaves = [x] + [t for k in ("embed", "wcol", "wrow") for t in p[k].pieces]
    for t in leaves:
        t.requires_grad_(True)
    tp = TP(p["wcol"])
    h = x + tp.embed(p["embed"], ids)
    g = tp.gather(tp.col(tp.bcast(h), p["wcol"]))
    g = torch.tanh(g) * g.sum(-1, keepdim=True)
    out = tp.row(tp.scatter(g), p["wrow"])
    loss = (out ** 2).sum() + (h * out).sum()
    grads = torch.autograd.grad(loss, leaves)
    pieces = {f"{k}{i}": grads[1 + j * len(p[k].pieces) + n].tolist()
              for j, k in enumerate(("embed", "wcol", "wrow")) for n, i in enumerate(p[k].index)}
    return {"loss": float(loss.detach()), "x": grads[0].tolist(), "pieces": pieces}


def _split_row_probe(rank: int, workdir: str) -> dict:
    """A (1, 4) mesh whose one data row is split over the two processes:
    ShardedTensor's global shape, split and full; the TP chain; a sharded
    state's checkpoint (written by process 0 alone, restored on one device
    by both)."""
    from theoremsearch_tpu_torch.encoder.sharding import _place
    from theoremsearch_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from theoremsearch_tpu_torch.train.contrastive import (
        init_sharded_train_state, init_train_state, tree_leaves,
    )

    m = make_mesh(MeshConfig(data=1, shard=4), devices=["cpu"] * 2)
    full = torch.arange(96, dtype=torch.float32).view(8, 12)
    st = _place(full, (None, "shard"), m)
    res = {"layout": m.layout, "index": st.index, "count": st.count, "shape": list(st.shape),
           "piece_shapes": [list(q.shape) for q in st.pieces],
           "full_equal": torch.equal(st.full(), full),
           "split_equal": all(torch.equal(q, b) for q, b in zip(
               st.split(2 * full).pieces, torch.tensor_split(2 * full, 4, dim=1)[2 * rank:]))}
    res["tp"] = _tp_mini(m)
    cfg = EncoderConfig(**{**EncoderConfig.tiny().__dict__, "dtype": "float32",
                           "param_dtype": "float32"})
    tcfg = TrainConfig(batch_size=4, seq_len=16)
    state = init_sharded_train_state(cfg, tcfg, m)
    writes, savez = [], np.savez
    np.savez = lambda *a, **k: (writes.append(str(a[0])), savez(*a, **k))[1]
    try:
        save_checkpoint(state, f"{workdir}/split")
    finally:
        np.savez = savez
    res["checkpoint_writes"] = len(writes)
    back = restore_checkpoint(f"{workdir}/split", cfg, tcfg, template=init_train_state(
        cfg, tcfg, generator=torch.Generator().manual_seed(7), device="cpu"))
    one = init_train_state(cfg, tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    res["checkpoint_equal_one_device"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back.params), tree_leaves(one.params)))
    return res


def _probe(rank: int, world: int, init: str, out: str, workdir: str) -> None:
    """One process of the group: every collective, the two gathers'
    gradients, a process-spanning mesh and a checkpoint, into JSON."""
    from theoremsearch_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from theoremsearch_tpu_torch.train.contrastive import (
        init_lora_train_state, init_sharded_train_state, piece_leaves,
    )

    torch.set_num_threads(1)
    pg = distributed.initialize(init, world, rank, device="cpu", timeout_s=120)
    res = {}
    try:
        gen = torch.Generator().manual_seed(rank)
        xs = {"bf16": torch.randn((4, 3), generator=gen).to(torch.bfloat16),
              "f16": torch.randn((4, 3), generator=gen).to(torch.float16),
              "f32": torch.randn((4, 3), generator=gen), "int8": torch.arange(12, dtype=torch.int8),
              "bool": torch.arange(6) % (rank + 2) == 0}
        res["gathered"] = {k: [g.view(torch.uint8).tolist() if g.dtype != torch.bool else g.tolist()
                               for g in distributed.all_gather(x, pg)] for k, x in xs.items()}
        res["gathered_dtypes"] = {k: [str(g.dtype) for g in distributed.all_gather(x, pg)]
                                  for k, x in xs.items()}
        s = distributed.all_reduce_sum(xs["bf16"], pg)
        res["bf16_sum"] = {"dtype": str(s.dtype), "bits": s.view(torch.int16).tolist()}
        flat = distributed.all_reduce_flat([xs["bf16"], xs["f32"], xs["f32"][:2], xs["bf16"][0]], pg)
        res["flat"] = [t.float().tolist() for t in flat]
        res["flat_dtypes"] = [str(t.dtype) for t in flat]
        res["broadcast"] = distributed.broadcast(xs["f32"], 1, pg).tolist()
        distributed.barrier(pg)
        # the autograd gather: the shipped backward and a reduce-scatter one
        for name, fn in (("shipped", distributed.gather_rows), ("reduce_scatter", ReduceScatterGather.apply)):
            x = _rows(rank).requires_grad_(True)
            y = fn(x, pg)
            loss = _loss(y)
            (g,) = torch.autograd.grad(loss, [x])
            res[name] = {"loss": float(loss), "grad": g.tolist()}
        res["stats"] = distributed.stats.snapshot()
        # a mesh across the two processes, and a straddling one refused
        m = make_mesh(MeshConfig(data=2, shard=4), devices=["cpu"] * 4)
        res["mesh"] = {"layout": m.layout, "local_rows": m.local_rows,
                       "devices": [str(d) for d in m.devices.flat]}
        try:
            make_mesh(MeshConfig(data=3, shard=2), devices=["cpu"] * 3)
            res["straddle"] = "accepted"
        except ValueError as e:
            res["straddle"] = str(e)
        try:
            make_mesh(None, devices=["cpu"] * (2 + rank))
            res["uneven_counts"] = "accepted"
        except ValueError as e:
            res["uneven_counts"] = str(e)
        # a sharded train state and a LoRA state over it (plain adapter
        # tensors, nothing sharded): process 0 writes each file, every
        # process restores both
        cfg = EncoderConfig(**{**EncoderConfig.tiny().__dict__, "dtype": "float32",
                               "param_dtype": "float32"})
        tcfg = TrainConfig(batch_size=4, seq_len=16)
        state = init_sharded_train_state(cfg, tcfg, m)
        lcfg = tcfg.replace(lora_rank=2)
        lora = init_lora_train_state(state.params, lcfg, generator=torch.Generator().manual_seed(5))
        writes, savez = [], np.savez
        np.savez = lambda *a, **k: (writes.append(str(a[0])), savez(*a, **k))[1]
        try:
            save_checkpoint(state, workdir)
            save_checkpoint(lora, f"{workdir}/lora")
        finally:
            np.savez = savez
        res["writes"] = len(writes)
        back = restore_checkpoint(workdir, cfg, tcfg, template=init_sharded_train_state(
            cfg, tcfg, m, generator=torch.Generator().manual_seed(99)))
        res["checkpoint_equal"] = all(torch.equal(a, b) for a, b in zip(
            piece_leaves(state.params), piece_leaves(back.params)))
        lback = restore_checkpoint(f"{workdir}/lora", cfg, lcfg, template=init_lora_train_state(
            state.params, lcfg, generator=torch.Generator().manual_seed(6)))
        res["lora_checkpoint_equal"] = all(torch.equal(a, b) for a, b in zip(
            piece_leaves(lora.params), piece_leaves(lback.params)))
        # one step's gradients with explicit negatives, summed over the group
        grads = _negatives_grads(cfg, state.params, m)
        if rank == 0:
            torch.save(grads, f"{workdir}/negatives_grads.pt")
        res["split_row"] = _split_row_probe(rank, workdir)
    finally:
        distributed.shutdown()
    with open(out, "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from torch_helpers import run_processes

    tmp = tmp_path_factory.mktemp("dist")
    outs = [tmp / f"r{r}.json" for r in range(2)]
    run_processes([[__file__, str(r), "2", f"file://{tmp}/rendezvous", str(outs[r]), str(tmp)]
                   for r in range(2)], tmp, timeout=120)
    return [json.loads(o.read_text()) for o in outs], tmp


def test_gather_is_bit_exact_in_rank_order(pair):
    res, _ = pair
    assert res[0]["gathered"] == res[1]["gathered"]
    for k, x in {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32,
                 "int8": torch.int8, "bool": torch.bool}.items():
        assert res[0]["gathered_dtypes"][k] == [str(x)] * 2
    g = res[0]["gathered"]["bf16"]
    for r in range(2):
        gen = torch.Generator().manual_seed(r)
        want = torch.randn((4, 3), generator=gen).to(torch.bfloat16)
        assert g[r] == want.view(torch.uint8).tolist()


def test_bf16_sum_through_gloo_equals_the_one_process_sum(pair):
    """Host staging: bf16 summed in f32 and cast back once, on every process."""
    res, _ = pair
    parts = [torch.randn((4, 3), generator=torch.Generator().manual_seed(r)).to(torch.bfloat16)
             for r in range(2)]
    want = (parts[0].float() + parts[1].float()).to(torch.bfloat16)
    for r in res:
        assert r["bf16_sum"]["dtype"] == "torch.bfloat16"
        assert r["bf16_sum"]["bits"] == want.view(torch.int16).tolist()
        assert r["flat_dtypes"] == ["torch.bfloat16", "torch.float32", "torch.float32",
                                    "torch.bfloat16"]
        assert r["flat"][0] == want.float().tolist() and r["flat"][3] == want[0].float().tolist()
        # the sum, the flat sum (one a dtype), the reduce-scatter backward
        assert r["stats"]["all_reduce"]["calls"] == 1 + 2 + 1
        assert r["stats"]["all_reduce"]["staged_bytes"] == 0    # CPU tensors: nothing staged
    assert res[0]["broadcast"] == res[1]["broadcast"]


def test_gather_rows_backward_gives_the_one_process_gradient(pair):
    """Every process takes the same loss of the gathered rows; the shipped
    backward hands each its own slice, which is the one-process gradient.
    A reduce-scatter backward doubles it at world size 2."""
    res, _ = pair
    x = torch.cat([_rows(0), _rows(1)]).requires_grad_(True)
    loss = _loss(x)
    (g,) = torch.autograd.grad(loss, [x])
    loss = loss.detach()
    for r in range(2):
        assert res[r]["shipped"]["loss"] == res[0]["shipped"]["loss"]
        assert abs(res[r]["shipped"]["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        want = g[3 * r : 3 * r + 3]
        np.testing.assert_allclose(res[r]["shipped"]["grad"], want, rtol=1e-6, atol=1e-6)
        bad = np.asarray(res[r]["reduce_scatter"]["grad"])
        assert not np.allclose(bad, want.numpy(), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(bad, 2 * want.numpy(), rtol=1e-6, atol=1e-6)


def test_mesh_across_processes_and_its_refusals(pair):
    res, _ = pair
    for r in range(2):
        m = res[r]["mesh"]
        assert m["layout"] == "data" and m["local_rows"] == [r]
        assert m["devices"] == (["cpu"] * 4 + ["None"] * 4 if r == 0 else ["None"] * 4 + ["cpu"] * 4)
        assert "unevenly" in res[r]["straddle"]
        assert "as many local devices" in res[r]["uneven_counts"]


def test_explicit_negatives_carry_gradient_once(pair):
    """Every process encodes the hard negatives; only process 0's carry
    gradient, so the summed gradient is the one-process mesh's."""
    from torch_helpers import cpu_mesh
    from theoremsearch_tpu_torch.train.contrastive import init_sharded_train_state

    _, tmp = pair
    got = torch.load(tmp / "negatives_grads.pt", weights_only=True)
    cfg = EncoderConfig(**{**EncoderConfig.tiny().__dict__, "dtype": "float32",
                           "param_dtype": "float32"})
    mesh = cpu_mesh(4, data=2)
    want = _negatives_grads(cfg, init_sharded_train_state(cfg, TrainConfig(batch_size=4, seq_len=16),
                                                          mesh).params, mesh)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_checkpoint_written_once_and_restored_everywhere(pair):
    """Process 0 writes the sharded state's file and the LoRA state's;
    process 1 writes neither, and both restore both."""
    res, tmp = pair
    assert [r["writes"] for r in res] == [2, 0]
    for r in res:
        assert r["checkpoint_equal"] and r["lora_checkpoint_equal"]
    assert sorted(p.name for p in tmp.iterdir() if p.name.startswith("step_")) == ["step_0.npz"]
    assert sorted(p.name for p in (tmp / "lora").iterdir()) == ["step_0.npz"]


def test_sharded_tensor_across_processes(pair):
    """On a (1, 4) mesh over two processes of two entries each process
    holds its block of pieces; `shape` is the global shape, `split` keeps
    the local blocks and `full` gathers the row (every process joins)."""
    res, _ = pair
    for r, x in enumerate(res):
        sr = x["split_row"]
        assert sr["layout"] == "shard" and sr["index"] == [2 * r, 2 * r + 1] and sr["count"] == 4
        assert sr["shape"] == [8, 12] and sr["piece_shapes"] == [[8, 3], [8, 3]]
        assert sr["full_equal"] and sr["split_equal"]


def test_tp_collectives_match_one_process_in_f64(pair):
    """`TP`'s embed, bcast, gather and row sum over a row split between two
    processes (`distributed.row_*`: each backward the conjugate
    collective) give the one-process mesh's loss and gradients in f64: the
    replicated input's gradient whole on both processes, each piece's
    gradient that of the same global piece in one process."""
    from theoremsearch_tpu_torch.core.meshes import Mesh

    res, _ = pair
    want = _tp_mini(Mesh(np.full((1, 4), torch.device("cpu"), dtype=object)))
    for x in res:
        got = x["split_row"]["tp"]
        assert abs(got["loss"] - want["loss"]) <= 1e-12 * abs(want["loss"])
        np.testing.assert_allclose(got["x"], want["x"], rtol=1e-12, atol=1e-12)
        assert len(got["pieces"]) == 6
        for k, g in got["pieces"].items():
            np.testing.assert_allclose(g, want["pieces"][k], rtol=1e-12, atol=1e-12, err_msg=k)


def test_split_row_checkpoint_written_once(pair):
    """A sharded state on a row split over the processes: both gather, only
    process 0 writes, and either restores it on one device bit-equal to
    the same seed's unsharded params."""
    res, _ = pair
    assert [x["split_row"]["checkpoint_writes"] for x in res] == [1, 0]
    assert all(x["split_row"]["checkpoint_equal_one_device"] for x in res)


if __name__ == "__main__":
    _probe(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
