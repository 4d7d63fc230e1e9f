"""One rank of a two-process sharded run on the CPU (gloo), started by
``tests/test_torch_shard.py`` and ``tests/test_torch_dist.py``:

    python tests/torch_shard_ranks.py --rank R --world W --store FILE \\
        --inputs IN.npz --out OUT.npz --what shard|dist|moe|train

It joins a gloo group through a ``FileStore`` at ``--store`` (no TCP
port, so parallel test workers cannot collide; a 60 s timeout, so a
hang fails), runs the port with one shard a rank and writes what it got
to ``--out``.  ``shard``: lockstep sssp WD and BS, one async WD run,
the error of a shard count that is not the world size, and what a WD
plan holds on this rank (its shards, their tensors' storage); ``dist``:
``distributed_sssp``; ``moe`` (started by
``tests/test_torch_moe_sharded.py``): ``sharded_moe_dispatch`` over the
whole batch, and ``ep_global_dispatch`` over this rank's rows of it;
``train`` (started by ``tests/test_torch_train.py``): one data-parallel
train step of the smoke ``qwen3_0_6b`` in float32 on this rank's rows of
the batch.  It imports nothing of JAX or ``repro``."""

import argparse
import datetime

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.algos import sssp
from repro_torch.core import dist, shard
from repro_torch.core.graph import CSRGraph
from repro_torch.core.strategies import make_strategy
from repro_torch.moe import sharded


def held_shards(g, world: int) -> dict:
    """What a WD plan of ``world`` shards holds on this rank: the held
    shard ids, each held tensor's storage bytes, the partition stack's
    bytes, and whether the held tensors equal the stack's rows."""
    wd = make_strategy("WD")
    splan = shard.plan_shards(wd, wd.setup(g), g, world)
    stack = (splan.sharded.row_ptr, splan.sharded.col, splan.sharded.wt)
    local = splan.local
    held = [(sh.row_ptr, sh.col, sh.wt) for sh in local]
    return {
        "held": np.array(splan.group.held),
        "held-storage": np.array([[t.untyped_storage().nbytes() for t in h]
                                  for h in held]),
        "stack-bytes": np.array([t.numel() * t.element_size()
                                 for t in stack]),
        "held-equal": np.array([
            all(torch.equal(t, st[s]) for t, st in zip(h, stack))
            for s, h in zip(splan.group.held, held)])}


def moe(inputs, rank: int, world: int) -> dict:
    """Both sharded dispatches with one shard a rank: the expert-parallel
    one over the whole batch (every rank holds the same tokens), the
    global one over this rank's block of rows."""
    t = {k: torch.from_numpy(inputs[k]) for k in inputs.files}
    experts = {k: t[k] for k in ("w_up", "w_gate", "w_down")}
    group = shard.shard_group(world, "cpu")
    E = experts["w_up"].shape[0]
    out = {"sharded": sharded.sharded_moe_dispatch(
        t["x"], t["ids"], t["w"], experts, group=group, num_experts=E,
        capacity=int(inputs["capacity"])).numpy()}
    rows = t["x"].shape[0] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    out["ep"] = sharded.ep_global_dispatch(
        t["x"][mine], t["ids"][mine], t["w"][mine], experts, group=group,
        num_experts=E, capacity=int(inputs["ep_capacity"])).numpy()
    return out


def train(inputs, rank: int, world: int) -> dict:
    """One train step over the group, this rank's rows of the batch:
    the metrics, the parameters and the first moments after it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import data_group
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_train_step
    cfg = get_config("qwen3_0_6b").smoke(dtype="float32")
    tokens = torch.from_numpy(inputs["tokens"])
    rows = tokens.shape[0] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    batch = {k: torch.from_numpy(inputs[k])[mine].long()
             for k in ("tokens", "labels")}
    shape = ShapeSpec("host", tokens.shape[1], tokens.shape[0], "train")
    step = build_train_step(cfg, shape, data_group("cpu"))
    state, metrics = step(step.init_state(), batch)
    out = {f"metric.{k}": v.numpy() for k, v in metrics.items()}
    out.update({f"param.{k}": v.detach().numpy()
                for k, v in state["params"].items()})
    out.update({f"m.{k}": v.numpy() for k, v in state["opt"]["m"].items()})
    # the compressed all-reduce over the process group, this rank's
    # gradient a seeded draw of its own
    from repro_torch.runtime.compression import allreduce_compressed
    g = torch.from_numpy(inputs["grads"][rank])
    mean, residual = allreduce_compressed(g, data_group("cpu").process_group,
                                          torch.zeros_like(g))
    out.update({"compressed.mean": mean.numpy(),
                "compressed.residual": residual.numpy()})
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--store", "--inputs", "--out", "--what"):
        ap.add_argument(name, required=True)
    args = ap.parse_args()
    tdist.init_process_group(
        "gloo", init_method=f"file://{args.store}", rank=args.rank,
        world_size=args.world, timeout=datetime.timedelta(seconds=60))
    try:
        inputs = np.load(args.inputs)
        if args.what in ("moe", "train"):
            fn = moe if args.what == "moe" else train
            np.savez(args.out, **fn(inputs, args.rank, args.world))
            return
        g = CSRGraph.from_arrays(inputs["row_ptr"], inputs["col"],
                                 inputs["wt"], device="cpu")
        source = int(inputs["source"])
        out = {}
        if args.what == "shard":
            for name, kw in (("WD", {}), ("BS", {}),
                             ("WD-async", dict(async_shards=True))):
                r = sssp(g, source, strategy=name.split("-")[0],
                         mode="fused", shards=args.world, device="cpu", **kw)
                out[name] = r.dist
                out[name + "-counts"] = np.array(
                    [r.iterations, r.edges_relaxed, r.relax_rounds,
                     r.shards])
            out.update(held_shards(g, args.world))
            try:
                shard.shard_group(args.world + 1, "cpu")
            except ValueError as e:
                out["error"] = np.array(str(e))
        else:
            out["dist"] = dist.distributed_sssp(
                g, source, shard.shard_group(args.world, "cpu"))
        np.savez(args.out, **out)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
