"""The port's process-group layer (`core/distributed.py`) and the mesh
across processes (`core/meshes.py`): the layout rule, the refusals, and
the collectives over Gloo at world size 2.

Everything that opens a process group runs in two subprocesses of this
file (`python tests/test_torch_distributed.py RANK WORLD INIT OUT`), so
no pytest worker keeps a group's global state; the tests read their JSON.
This file imports no jax."""

import json
import sys

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.core import distributed
from theoremsearch_tpu_torch.core.config import EncoderConfig, MeshConfig, TrainConfig
from theoremsearch_tpu_torch.core.distributed import ProcessGroup, process_layout
from theoremsearch_tpu_torch.core.meshes import Mesh, make_mesh

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
])
def test_process_layout_accepts_the_two_layouts(data, shard, n_local, n_proc, want):
    assert process_layout(data, shard, n_local, n_proc) == want


@pytest.mark.parametrize("data, shard, n_local, n_proc, match", [
    (2, 3, 2, 3, "unevenly"),          # a block straddles two data rows
    (2, 4, 2, 4, "unevenly"),          # data rows split over processes with data > 1
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
    pg = ProcessGroup(None, rank, world, "gloo", torch.device("cpu"))
    layout = process_layout(data, shard, n_local, world)
    grid = np.empty(data * shard, dtype=object)
    local = np.zeros(data * shard, bool)
    grid[rank * n_local : (rank + 1) * n_local] = [torch.device("cpu")] * n_local
    local[rank * n_local : (rank + 1) * n_local] = True
    return Mesh(grid.reshape(data, shard), process_group=pg, local=local.reshape(data, shard),
                layout=layout)


def test_mesh_positions_of_each_layout():
    a = _spanning_mesh(1, 8, 4, 1, 2)
    assert a.home_row == 0 and a.local_rows == []
    assert [s for s, _ in a.local_shards] == [4, 5, 6, 7]
    assert a.shard_group is a.process_group and a.data_group is None
    b = _spanning_mesh(2, 4, 4, 1, 2)
    assert b.home_row == 1 and b.local_rows == [1] and b.data_devices == [torch.device("cpu")]
    assert [s for s, _ in b.local_shards] == [0, 1, 2, 3] and len(b.shard_devices) == 4
    assert b.data_group is b.process_group and b.shard_group is None
    one = make_mesh(MeshConfig(data=2, shard=2), devices=["cpu"] * 4)
    assert one.process_group is None and one.layout == "local" and one.local_rows == [0, 1]
    assert one.shard_group is None and one.data_group is None


def test_tensor_parallel_across_processes_raises():
    """Params whose shard axis crosses a process boundary (a data row that
    spans processes), and the dp paths over such a row, name the ROADMAP
    item instead of running."""
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.model import init_params, shard_params
    from theoremsearch_tpu_torch.train.contrastive import _encode_rows

    mesh = _spanning_mesh(1, 8, 4, 0, 2)
    cfg = EncoderConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        shard_params(params, mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        BatchedEncoder(params, cfg, mesh=mesh)
    ids = torch.zeros((8, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        _encode_rows(params, ids, ids, cfg, "on", mesh)
    with pytest.raises(NotImplementedError):
        mesh.shard_devices


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
    if mesh.data_group is not None:
        grads = distributed.all_reduce_flat(grads, mesh.data_group)
    return [g.detach() for g in logical_grads(params, grads)]


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


if __name__ == "__main__":
    _probe(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
