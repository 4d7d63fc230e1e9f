"""The port's graph-query server (``repro_torch.serve``) against the
reference's (``repro.serve``), on the CPU: the same request streams, each
under its own ``SimulatedClock``, go through the reference
``GraphServer`` (``backend="xla"``) and the port's
``GraphServer(device="cpu")``, and give equal response sequences (id,
status, reason, distance rows bit for bit, finish time, ``batch_lanes``,
``cached``) and equal ``stats()``.  The streams follow the designs of
``tests/test_serving.py`` and ``tests/test_serving_cache.py``: both
operators and modes, multi-tenant graphs, swaps, pinned landmarks under
LRU pressure, queue-full and expired rejects, EDF order, a deadline miss
and ``drain(max_steps=)`` raising.  Plus the port's own parts: served
rows equal ``engine.run``, K-bucket accounting in ``ExecutableCache``,
one fused ``DISPATCH_COUNTS["batch"]`` step a dispatched batch, and
the launcher."""

import numpy as np
import pytest

from repro import serve as jserve
from repro.data import graphs as jgraphs
from repro_torch import serve as tserve
from repro_torch.core import engine, fused
from repro_torch.core.graph import CSRGraph
from repro_torch.core.strategies import make_strategy
from repro_torch.launch import serve_graph

JAX_GRAPHS = {
    "rmat": jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True, seed=1),
    "rmat_v2": jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True,
                                  seed=2),
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
    "er": jgraphs.erdos_renyi_graph(scale=8, edge_factor=4, weighted=True,
                                    seed=3),
}


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(
        np.asarray(jg.row_ptr), np.asarray(jg.col),
        None if jg.wt is None else np.asarray(jg.wt), device="cpu")


GRAPHS = {name: _port(jg) for name, jg in JAX_GRAPHS.items()}

SIDES = {
    "reference": (jserve, JAX_GRAPHS, {}),
    "port": (tserve, GRAPHS, {"device": "cpu"}),
}


def _event(r) -> tuple:
    dist = None if r.dist is None else (np.asarray(r.dist).dtype.str,
                                        np.asarray(r.dist).tobytes())
    q = r.request
    return (q.id, q.source, q.graph, q.op, r.status, r.reason, dist,
            r.finish_time, r.cached, r.batch_lanes)


def _drive(side: str, script, **server_kw):
    """Run ``script`` (a list of actions) on one side; returns the events
    (terminal responses in order, and raised errors) and ``stats()``."""
    mod, graphs, extra = SIDES[side]
    clk = mod.SimulatedClock()
    srv = mod.GraphServer(clock=clk, **server_kw, **extra)
    events = []
    for action, *args in script:
        if action == "load":
            name, gkey = args
            events.append(("epoch", srv.load_graph(name, graphs[gkey])))
        elif action == "unload":
            srv.unload_graph(*args)
        elif action == "submit":
            resp = srv.submit(mod.Request(**args[0]))
            events.append(None if resp is None else _event(resp))
        elif action == "advance":
            clk.advance(*args)
        elif action == "step":
            events.extend(_event(r) for r in srv.step())
        elif action == "warm":
            name, sources, op = args
            events.append(("pinned", srv.warm(name, sources, op=op)))
        elif action == "drain":
            try:
                events.extend(_event(r) for r in srv.drain(*args))
            except RuntimeError as err:
                events.append(("raised", str(err)))
                events.extend(_event(r) for r in err.responses)
        events.append(("depth", srv.queue_depth))
    return events, srv.stats()


def _same_on_both(script, **server_kw):
    want = _drive("reference", script, **server_kw)
    got = _drive("port", script, **server_kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    return got


def _submit(source, graph="g", **kw):
    return ("submit", dict(source=source, graph=graph, **kw))


@pytest.mark.parametrize("mode", ["fused", "stepped"])
@pytest.mark.parametrize("op", ["shortest_path", "widest_path"])
def test_rows_then_cache_hits(op, mode):
    sources = [1, 5, 9, 13, 2, 7]
    script = ([("load", "g", "rmat")]
              + [_submit(s, op=op) for s in sources]
              + [("advance", 0.5), ("drain",)]
              + [_submit(s, op=op) for s in sources])
    events, stats = _same_on_both(script, max_batch=4, mode=mode)
    assert stats["completed"] == 12 and stats["result_cache_hits"] == 6


def test_multi_tenant_swap_and_pinned_landmarks():
    """Two tenants that never share a batch; landmarks pinned by warm()
    survive LRU pressure until a swap drops them with everything else of
    the graph."""
    script = [("load", "a", "rmat"), ("load", "b", "road"),
              ("warm", "a", [3, 17], "shortest_path")]
    for s in [1, 4, 8]:
        script += [_submit(s, graph="a"), _submit(s, graph="b")]
    script += [("advance", 1.0), ("drain",)]
    script += [_submit(s, graph="a") for s in [20, 21, 22, 3, 17]]
    script += [("step",), ("advance", 0.25)]
    script += [_submit(s, graph="a") for s in [3, 17, 1]]
    script += [("load", "a", "rmat_v2")]              # swap: epoch 1
    script += [_submit(s, graph="a") for s in [3, 17, 1]]
    script += [("drain",), ("unload", "b"), _submit(4, graph="b")]
    events, stats = _same_on_both(script, max_batch=4,
                                  result_cache_capacity=3)
    assert stats["graph_swaps"] == 1 and stats["landmarks_pinned"] == 2
    assert stats["rejected:unknown_graph"] == 1


def test_rejects_deadlines_and_edf_order():
    script = [("load", "g", "er")]
    script += [_submit(s, deadline=d) for s, d in
               [(1, 0.5), (2, None), (3, 50.0), (4, 5.0), (5, 6.0)]]
    script += [_submit(6)]                            # queue full
    script += [("advance", 1.0), ("step",), ("step",)]
    script += [_submit(7, deadline=0.5)]              # expired at admission
    script += [_submit(8, deadline=3.0), ("advance", 0.5), ("drain",)]
    events, stats = _same_on_both(script, max_queue=5, max_batch=2)
    assert stats["rejected:queue_full"] == 1
    assert stats["rejected:deadline_expired"] == 2
    assert stats["submitted"] == stats["completed"] + stats["rejected_total"]


def test_drain_raises_on_an_exhausted_budget():
    script = [("load", "g", "road")]
    script += [_submit(s) for s in (1, 2, 3)]
    script += [("drain", 1), ("advance", 2.0), ("drain", 1), ("drain",),
               ("drain", 0)]
    events, stats = _same_on_both(script, max_batch=1)
    raised = [e for e in events if e and e[0] == "raised"]
    assert len(raised) == 2 and "still queued" in raised[0][1]
    assert stats["completed"] == 3


def test_open_loop_trace_with_mixed_operators():
    script = [("load", "g", "rmat")]
    script += [_submit(1), _submit(2, op="widest_path"), _submit(3)]
    script += [("advance", 1.0), ("step",), ("advance", 1.0)]
    script += [_submit(4), _submit(5), ("advance", 1.0), ("step",),
               ("step",)]
    events, stats = _same_on_both(script, max_queue=8, max_batch=4)
    assert stats["batches"] == 3
    assert stats["lanes_dispatched"] == 2 + 2 + 1


def test_served_rows_equal_engine_run():
    srv = tserve.GraphServer(clock=tserve.SimulatedClock(), max_batch=4,
                             device="cpu")
    srv.load_graph("g", GRAPHS["road"])
    for s in [0, 10, 20]:
        assert srv.submit(tserve.Request(source=s, graph="g")) is None
    done = srv.drain()
    for r in done:
        want = engine.run(GRAPHS["road"], r.request.source,
                          make_strategy("WD"), mode="fused", device="cpu")
        np.testing.assert_array_equal(r.dist, want.dist)
        assert not r.dist.flags.writeable


def test_one_fused_batch_a_dispatch_and_bucket_accounting():
    """The reference's "no recompile" gate becomes one fused batch a
    dispatch: K-buckets 4, 2, 1, 4, 4 are three misses and two hits."""
    srv = tserve.GraphServer(clock=tserve.SimulatedClock(), max_batch=4,
                             result_cache_capacity=1, device="cpu")
    srv.load_graph("g", GRAPHS["er"])
    before = fused.DISPATCH_COUNTS["batch"]
    rounds = [[1, 2, 3], [4, 5], [6], [7, 8, 9], [10, 11, 12]]
    for sources in rounds:
        for s in sources:
            assert srv.submit(tserve.Request(source=s, graph="g")) is None
        srv.drain()
    assert fused.DISPATCH_COUNTS["batch"] - before == len(rounds)
    stats = srv.stats()
    assert stats["exec_cache_misses"] == 3
    assert stats["exec_cache_hits"] == 2
    keys = srv.executable_cache.resident_keys()
    assert sorted(k[-1] for k in keys) == [1, 2, 4]
    assert keys[0] == ("g", 0, "shortest_path", "bsp", None, 2)


def test_requests_validate_their_knobs():
    srv = tserve.GraphServer(clock=tserve.SimulatedClock(), mode="stepped",
                             device="cpu")
    srv.load_graph("g", GRAPHS["er"])
    with pytest.raises(KeyError):
        srv.submit(tserve.Request(source=0, graph="g", op="no_such_op"))
    with pytest.raises(ValueError, match="fused"):
        srv.submit(tserve.Request(source=0, graph="g", schedule="delta"))
    # delta requests (A10) have landed: a fused server batches them by
    # (graph, epoch, op, schedule, delta), as the reference's does
    script = ([("load", "g", "er")]
              + [_submit(s, schedule="delta") for s in (0, 3)]
              + [_submit(5, schedule="delta", delta=20), _submit(7)]
              + [("advance", 0.5), ("drain",)])
    events, stats = _same_on_both(script, max_batch=4)
    assert stats["completed"] == 4 and stats["batches"] == 3
    assert not hasattr(tserve.Request(source=0), "backend")
    with pytest.raises(ValueError):
        tserve.GraphServer(mode="warp", device="cpu")
    with pytest.raises(ValueError):
        tserve.GraphServer(max_queue=0, device="cpu")


def test_launcher_serves_the_example_traffic(capsys):
    """``launch.serve_graph`` on the CPU: every ``ok`` row equals its
    source's single-source fused run."""
    g = GRAPHS["rmat"]
    srv, done = serve_graph.serve(g, "rmat", queries=10, max_batch=4,
                                  burst=4, landmarks=2, device="cpu",
                                  clock=tserve.SimulatedClock())
    assert len(done) == 10
    assert all(r.ok for r in done)
    for r in done:
        want = engine.run(g, r.request.source, make_strategy("WD"),
                          mode="fused", device="cpu")
        np.testing.assert_array_equal(r.dist, want.dist)
    stats = srv.stats()
    assert stats["landmarks_pinned"] == 2 and stats["completed"] == 10
    serve_graph.report(done, stats)
    assert "10 submitted, 10 served" in capsys.readouterr().out
