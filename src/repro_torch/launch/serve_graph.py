"""Graph-query serving launcher: a resident graph answering a stream of
BFS/SSSP queries with deadlines through :class:`repro_torch.serve.GraphServer`.

    PYTHONPATH=src python -m repro_torch.launch.serve_graph \\
        --queries 12 --max-batch 4 --graph rmat --algo sssp
    PYTHONPATH=src python -m repro_torch.launch.serve_graph --device cpu

Load the graph, pin ``--landmarks`` hot sources in the distance cache,
push an open-loop stream of queries in bursts of ``--burst`` with a
deadline each, and let the deadline-aware continuous batcher re-bucket K
and dispatch fused ``run_batch`` launches.  The sources are drawn with
``--seed`` from the 10% highest-degree nodes, so queries land in the
giant component and repeats exercise the distance cache.  Every number
printed at the end comes from ``GraphServer.stats()``.  Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.data import make_graph
from repro_torch.serve import GraphServer, Request


def high_degree_pool(g: CSRGraph) -> np.ndarray:
    """The 10% highest-degree nodes (at least one), highest first."""
    order = np.argsort(g.degrees.cpu().numpy())[::-1]
    return order[: max(g.num_nodes // 10, 1)]


def serve(g: CSRGraph, name: str, *, queries: int = 12, max_batch: int = 4,
          max_queue: int = 64, deadline: float = 30.0, landmarks: int = 2,
          burst: int = 4, seed: int = 0, device="cuda", clock=None):
    """Serve ``queries`` SSSP/BFS queries on ``g`` (the operator follows
    the graph: weighted gives distances, unweighted levels).  Returns
    ``(server, responses)``, every submission's terminal response."""
    rng = np.random.default_rng(seed)
    pool = high_degree_pool(g)
    sources = rng.choice(pool, size=queries)

    srv = GraphServer(max_queue=max_queue, max_batch=max_batch,
                      device=device, clock=clock)
    srv.load_graph(name, g)
    if landmarks:
        srv.warm(name, pool[:landmarks])

    done = []
    for start in range(0, len(sources), burst):
        for src in sources[start:start + burst]:        # arrival burst
            resp = srv.submit(Request(source=int(src), graph=name,
                                      deadline=srv.clock() + deadline))
            if resp is not None:                  # cache hit or reject
                done.append(resp)
        done.extend(srv.step())                   # continuous batching
    done.extend(srv.drain())
    return srv, done


def report(done, stats) -> None:
    for r in done:
        if r.ok:
            reached = int((r.dist < np.iinfo(np.int32).max // 2).sum())
            print(f"query {r.request.id:3d}: source={r.request.source:6d} "
                  f"reached={reached:6d} lanes={r.batch_lanes} "
                  f"{'cache-hit' if r.cached else 'traversed'} "
                  f"latency={r.latency * 1e3:7.1f}ms")
        else:
            print(f"query {r.request.id:3d}: source={r.request.source:6d} "
                  f"REJECTED ({r.reason})")
    s = stats
    print(f"\n{s['submitted']} submitted, {s.get('completed', 0)} served "
          f"({s.get('result_cache_hits', 0)} cache hits), "
          f"{s.get('rejected_total', 0)} rejected; "
          f"{s.get('batches', 0)} batches at "
          f"occupancy={s['batch_occupancy'] or 0:.2f}; "
          f"p50={s['latency_p50'] * 1e3:.1f}ms "
          f"p99={s['latency_p99'] * 1e3:.1f}ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--deadline", type=float, default=30.0,
                    help="per-request deadline, seconds from submit")
    ap.add_argument("--landmarks", type=int, default=2,
                    help="hot sources pinned in the distance cache")
    ap.add_argument("--burst", type=int, default=4,
                    help="arrivals per batcher turn (open-loop burstiness)")
    ap.add_argument("--graph", default="rmat",
                    help="name from repro_torch.data.GRAPH_SUITE")
    ap.add_argument("--algo", choices=["sssp", "bfs"], default="sssp")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = make_graph(args.graph, weighted=(args.algo == "sssp"),
                   device=args.device)
    srv, done = serve(g, args.graph, queries=args.queries,
                      max_batch=args.max_batch, max_queue=args.max_queue,
                      deadline=args.deadline, landmarks=args.landmarks,
                      burst=args.burst, seed=args.seed, device=args.device)
    report(done, srv.stats())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
