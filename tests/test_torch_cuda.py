"""The port's CUDA kernels on the card: each against its plain PyTorch
version (the relax kernels exactly, B4/B5 within tests/test_kernels.py's
tolerances), the wrappers' argument checks, the stepped engine (all six
strategies, connected components, widest path), the fused fixed point
(against its plain loop on the card and the CPU, one launch a traversal),
the batched queries (B1's batch contract and the fused batch, a launch a
row, against their plain versions, ``run_batch`` and ``GraphServer`` against
the CPU), delta-stepping (the fused kernel's delta mode against its plain
epoch loop, the engines, batch and server against the CPU), measured AD
(``ad_choice`` against ``CostModel.choose``, calibration, block
feasibility), user-defined, float32 and sub-word operators (their own
builds of B1, B2, B1's batch contract and the fused kernel against the
plain versions), the serving loop, the expert-parallel MoE dispatch, and
the MLA, vision, audio and padded-head models on the card against the
CPU.  Every test here needs a CUDA
device and skips
without one.  The file imports neither JAX nor ``repro``, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.algos import (bfs, connected_components, reference_widest,
                               sssp, widest_path)
from repro_torch.core import operators
from repro_torch.core.graph import CSRGraph
from repro_torch.data import rmat_graph
from repro_torch.kernels import find_offsets as fo
from repro_torch.kernels import relax

pytestmark = pytest.mark.cuda

OP_NAMES = ["shortest_path", "min_label", "widest_path", "reach_count"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lanes(rng, op, n, lanes, dev):
    dist = rng.integers(0, 60, n).astype(np.int32)
    if op.combine == "min":
        dist[rng.random(n) < 0.4] = op.identity
    arrays = (dist, rng.integers(0, n, lanes).astype(np.int32),
              rng.integers(0, n, lanes).astype(np.int32),
              rng.integers(1, 9, lanes).astype(np.int32),
              rng.random(lanes) < 0.7)
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


#: B2's lane counts: not multiples of a block tile's 512 lanes (2, 7,
#: 2050, 4099, 100000), odd ones, which leave a thread's second lane
#: empty (7, 4099), and more lanes than one wave of blocks holds
#: (3,000,001)
B2_SHAPES = [(3, 2), (5, 7), (257, 2050), (1000, 4099), (5000, 100000),
             (5000, 3000001)]


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("n,lanes", B2_SHAPES)
def test_relax_lanes_kernel_matches_plain(dev, opname, n, lanes):
    op = operators.OPERATORS[opname]
    args = _lanes(np.random.default_rng(n + lanes), op, n, lanes, dev)
    before = relax.LAUNCHES["relax_lanes"]
    got = relax.relax_lanes(*args, op=op)
    assert relax.LAUNCHES["relax_lanes"] == before + 1
    _same(got, relax.relax_lanes_plain(*args, op=op))


def _running_mask(rng, n, dev):
    """A non-empty running ``updated`` mask, as BS's columns and HP's
    sub-iterations carry it."""
    return torch.from_numpy(rng.random(n) < 0.2).to(dev)


def _check_apply_relax(dev, op, args, mask):
    """B2's fold into ``dist`` against its plain version: one launch, the
    caller's mask set in place."""
    dist, src, dst, w, valid = args
    want = relax.apply_relax_plain(dist, mask.clone(), src, dst, w, valid,
                                   op=op)
    before = relax.LAUNCHES["relax_lanes"]
    got = relax.apply_relax(dist, mask, src, dst, w, valid, op=op)
    assert relax.LAUNCHES["relax_lanes"] == before + 1
    assert got[1] is mask
    _same(got, want)


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("n,lanes", B2_SHAPES)
def test_apply_relax_kernel_matches_plain(dev, opname, n, lanes):
    op = operators.OPERATORS[opname]
    rng = np.random.default_rng(n * 7 + lanes)
    args = _lanes(rng, op, n, lanes, dev)
    _check_apply_relax(dev, op, args, _running_mask(rng, n, dev))


@pytest.mark.parametrize("opname", OP_NAMES)
def test_relax_lanes_kernel_takes_views_off_a_16_byte_boundary(dev, opname):
    """Lanes given as views that start one element into their storage,
    off every vector boundary: the kernel loads lane by lane."""
    op = operators.OPERATORS[opname]
    rng = np.random.default_rng(11)
    dist, *lane_args = _lanes(rng, op, 300, 1001, dev)
    src, dst, w, valid = (t[1:] for t in lane_args)
    args = (dist, src, dst, w, valid)
    _same(relax.relax_lanes(*args, op=op),
          relax.relax_lanes_plain(*args, op=op))
    _check_apply_relax(dev, op, args, _running_mask(rng, 300, dev))


@pytest.mark.parametrize("opname", OP_NAMES)
def test_relax_lanes_kernel_matches_plain_on_hp_tiles(dev, opname):
    """HP's ``[cap, MDT]`` tiles (as ``strategies.hp_sub_relax`` builds
    them): most lanes invalid, which load nothing past their valid
    bytes."""
    op = operators.OPERATORS[opname]
    g = rmat_graph(scale=12, weighted=True, seed=2, device=dev)
    rng = np.random.default_rng(5)
    nodes = np.full(1024, -1, np.int32)
    nodes[:700] = np.sort(rng.choice(g.num_nodes, 700, replace=False))
    sub = torch.from_numpy(nodes).to(dev)
    cursor = torch.from_numpy(rng.integers(0, 4, 1024).astype(np.int32)
                              ).to(dev)
    mdt = 64
    mask = sub >= 0
    nn = torch.where(mask, sub, 0)
    deg = g.row_ptr[nn + 1] - g.row_ptr[nn]
    pos = cursor[:, None] + torch.arange(mdt, dtype=torch.int32,
                                         device=dev)[None, :]
    valid = (mask[:, None] & (pos < deg[:, None])).reshape(-1)
    eidx = (g.row_ptr[nn][:, None] + pos).clamp_(0, g.num_edges - 1)
    eidx = eidx.reshape(-1)
    src = nn[:, None].expand(-1, mdt).reshape(-1)
    assert float(valid.float().mean()) < 0.5
    dist = _lanes(rng, op, g.num_nodes, 1, dev)[0]
    args = (dist, src, g.col[eidx], g.wt[eidx], valid)
    _same(relax.relax_lanes(*args, op=op),
          relax.relax_lanes_plain(*args, op=op))
    _check_apply_relax(dev, op, args, _running_mask(rng, g.num_nodes, dev))


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("cursor_max", [0, 2])
def test_wd_relax_lanes_kernel_matches_plain(dev, opname, weighted,
                                              cursor_max):
    op = operators.OPERATORS[opname]
    g = rmat_graph(scale=10, weighted=True, seed=3, device=dev)
    rng = np.random.default_rng(7)
    nodes = np.sort(rng.choice(g.num_nodes, 300, replace=False))
    f = torch.from_numpy(nodes.astype(np.int32)).to(dev)
    cursor = torch.from_numpy(rng.integers(0, cursor_max + 1, 300)
                              .astype(np.int32)).to(dev)
    deg = (g.row_ptr[f + 1] - g.row_ptr[f] - cursor).clamp_(min=0)
    prefix = torch.cumsum(deg, 0, dtype=torch.int32)
    dist = _lanes(rng, op, g.num_nodes, 1, dev)[0]
    args = (dist, prefix, prefix - deg, g.row_ptr[f] + cursor, f, g.col,
            g.wt if weighted else None)
    cap = int(prefix[-1]) + 100             # spare lanes stay invalid
    before = relax.LAUNCHES["wd_relax_lanes"]
    got = relax.wd_relax_lanes(*args, cap_work=cap, op=op)
    assert relax.LAUNCHES["wd_relax_lanes"] == before + 1
    _same(got, relax.wd_relax_lanes_plain(*args, cap_work=cap, op=op))
    _check_wd_apply_relax(op, args, cap, _running_mask(rng, g.num_nodes,
                                                       dev))


def _check_wd_apply_relax(op, args, cap, mask):
    """B1's fold into ``dist`` against its plain version: one launch, the
    caller's mask set in place."""
    dist, *rest = args
    want = relax.wd_apply_relax_plain(dist, mask.clone(), *rest,
                                      cap_work=cap, op=op)
    before = relax.LAUNCHES["wd_relax_lanes"]
    got = relax.wd_apply_relax(dist, mask, *rest, cap_work=cap, op=op)
    assert relax.LAUNCHES["wd_relax_lanes"] == before + 1
    assert got[1] is mask
    _same(got, want)


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("weighted", [True, False])
def test_wd_relax_lanes_kernel_matches_plain_past_shared_memory(
        dev, opname, weighted):
    """Runs of thousands of zero-degree slots (HP's tail cursors past the
    end) between busy ones: a block tile's slot slice outgrows the shared
    memory that stages it (2048 slots), and its lanes search ``prefix``
    in global memory; the tiles beside it are staged.  The frontier
    spans more tiles than one wave of blocks."""
    op = operators.OPERATORS[opname]
    g = rmat_graph(scale=18, weighted=True, seed=4, device=dev)
    rng = np.random.default_rng(9)
    f_slots = g.num_nodes
    f = torch.arange(f_slots, dtype=torch.int32, device=dev)
    cursor = rng.integers(0, 2, f_slots).astype(np.int32)
    for lo, hi in ((100, 5100), (6000, 8500), (9000, 9001),
                   (120000, 200000)):
        cursor[lo:hi] = 1 << 20             # past the end: degree 0
    cursor = torch.from_numpy(cursor).to(dev)
    deg = (g.row_ptr[f + 1] - g.row_ptr[f] - cursor).clamp_(min=0)
    prefix = torch.cumsum(deg, 0, dtype=torch.int32)
    dist = _lanes(rng, op, g.num_nodes, 1, dev)[0]
    args = (dist, prefix, prefix - deg, g.row_ptr[f] + cursor, f, g.col,
            g.wt if weighted else None)
    cap = int(prefix[-1]) + 3000
    _same(relax.wd_relax_lanes(*args, cap_work=cap, op=op),
          relax.wd_relax_lanes_plain(*args, cap_work=cap, op=op))
    _check_wd_apply_relax(op, args, cap, _running_mask(rng, g.num_nodes,
                                                       dev))


@pytest.mark.parametrize("f,cap", [(0, 64), (1, 1), (200, 1025),
                                   (4096, 300000)])
def test_find_offsets_kernel_matches_plain(dev, f, cap):
    deg = np.random.default_rng(f).integers(0, 9, f)
    prefix = torch.from_numpy(np.cumsum(deg).astype(np.int32)).to(dev)
    _same([fo.find_offsets(prefix, cap)], [fo.find_offsets_plain(prefix,
                                                                  cap)])


def test_wrappers_reject_bad_arguments(dev):
    op = operators.shortest_path
    dist, src, dst, w, valid = _lanes(np.random.default_rng(0), op, 50, 80,
                                      dev)
    with pytest.raises(TypeError):
        relax.relax_lanes(dist, src.long(), dst, w, valid)
    with pytest.raises(ValueError):
        relax.relax_lanes(dist, src[::2], dst[:40], w[:40], valid[:40])
    with pytest.raises(ValueError):
        relax.relax_lanes(dist, src, dst[:10], w, valid)
    with pytest.raises(ValueError):
        relax.relax_lanes(dist, src.cpu(), dst, w, valid)
    with pytest.raises(TypeError):
        fo.find_offsets(torch.arange(5, device=dev), 8)


#: user-defined operators, whose callables are lowered to C++ and whose
#: kernels are built for them at first use (one library each, cached by
#: operator): the reference's slack operator (its update predicate in the
#: kernel), a weight penalty above T = 20 (weight_additive) and a budget
#: spent along the path (max, value_min 0)
CUSTOM_OPS = {
    "slack": operators.EdgeOp(
        name="slack", combine="min", identity=operators.INF,
        source_value=0, message=lambda v, w: v + w,
        update=lambda cand, cur: cand + 2 < cur),
    "penalty": operators.EdgeOp(
        name="penalty", combine="min", identity=operators.INF,
        source_value=0, weight_additive=True,
        message=lambda v, w: torch.where(w > 20, v + 2 * w, v + w)),
    "budget": operators.EdgeOp(
        name="budget", combine="max", identity=0, source_value=200,
        value_min=0, message=lambda v, w: (v - w).clamp(min=0)),
}

#: int32 extremes planted among the lanes' values and weights
EXTREMES = (-2 ** 31, 2 ** 31 - 1, operators.INF, 0, -1)


_DIV = operators.EdgeOp(name="halved", combine="min",
                        identity=operators.INF, source_value=0,
                        message=lambda v, w: v / 2 + w)
_F32 = operators.EdgeOp(name="f32", combine="min",
                        identity=float(operators.INF), source_value=0.0,
                        message=lambda v, w: v + w, dtype=torch.float32)


def _replace(op, **kw):
    import dataclasses
    return dataclasses.replace(op, name=str(kw.get("dtype", op.name)), **kw)


#: what the card takes: (operator, the error it raises before any build
#: or launch, or None if it is accepted with one launch of its build)
CARD_OPERATOR_CASES = {
    "truediv": (_DIV, "'truediv'.*device='cpu'"),
    "add1_int32": (operators.EdgeOp(name="add1", combine="add", identity=1,
                                    source_value=1,
                                    message=lambda v, w: v),
                   "nonzero identity.*reference's faults"),
    "add1_float32": (_replace(_F32, combine="add", identity=1.0),
                     "nonzero identity.*reference's faults"),
    "float32": (_F32, None),
    "float16": (_replace(_F32, dtype=torch.float16), None),
    "bfloat16": (_replace(_F32, dtype=torch.bfloat16), None),
    "int16": (_replace(_F32, dtype=torch.int16, identity=32767), None),
    "uint8": (_replace(_F32, dtype=torch.uint8, identity=255), None),
    "float64": (_replace(_F32, dtype=torch.float64), None),
}


@pytest.mark.parametrize("case", list(CARD_OPERATOR_CASES))
def test_custom_operator_on_cuda_raises(dev, case):
    """An operator outside the lowered op set (true division of int32
    values) and add with a nonzero identity (int32 or float32: the
    reference's fault) raise on CUDA tensors before any build or launch,
    naming the fx node or the fault; neither runs the plain version.
    Every kernel value type is accepted (float64 as float32): its own
    build, one launch, the value type's proposal."""
    op, error = CARD_OPERATOR_CASES[case]
    args = _lanes(np.random.default_rng(1), _DIV, 50, 80, dev)
    value = operators.value_dtype(op)
    before = dict(relax.LAUNCHES)
    if error is None:
        got = relax.apply_relax(args[0].to(value),
                                torch.zeros_like(args[4][:50]), *args[1:],
                                op=op)
        assert got[0].dtype == value
        assert relax.LAUNCHES["relax_lanes"] == before["relax_lanes"] + 1
        return
    with pytest.raises(NotImplementedError, match=error):
        relax.apply_relax(args[0].to(value), torch.zeros_like(args[4][:50]),
                          *args[1:], op=op)
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    g = rmat_graph(scale=8, weighted=True, seed=1, device="cpu")
    for mode in ("stepped", "fused"):
        with pytest.raises(NotImplementedError, match=error):
            engine.run(g, 0, make_strategy("WD"), op=op, mode=mode,
                       device=dev)
    assert relax.LAUNCHES == before


def _with_extremes(rng, t):
    """``t`` with a tenth of its entries set to int32 extremes."""
    a = t.cpu().numpy().copy()
    at = rng.random(a.size) < 0.1
    a[at] = rng.choice(EXTREMES, int(at.sum()))
    return torch.from_numpy(a).to(t.device)


def _in_domain(op, t):
    """``t`` inside ``op``'s value domain, ``t`` folded with the identity
    (a min monoid's values at or below its identity, a max monoid's at or
    above; −0.0 lies below a float max's or add's +0.0): only there does
    the fold into a copy of dist equal ``apply_proposal``'s ``min(dist,
    proposal)``, which lowers an untouched entry above INF."""
    return op.fold_values(t, torch.full_like(t, op.identity))


@pytest.mark.parametrize("opname", list(CUSTOM_OPS))
def test_custom_operator_kernels_match_plain(dev, opname):
    """B2, B1 and B1's batch contract built for a user-defined operator,
    against their plain versions on the same card tensors bit for bit,
    values and weights with int32 extremes among them (the folds into
    dist: the values in the operator's domain); one launch each."""
    from repro_torch.core import multi_source
    op = CUSTOM_OPS[opname]
    rng = np.random.default_rng(17)
    for n, lanes in ((257, 2050), (5000, 100000)):
        dist, src, dst, w, valid = _lanes(rng, op, n, lanes, dev)
        args = (_with_extremes(rng, dist), src, dst, _with_extremes(rng, w),
                valid)
        before = relax.LAUNCHES["relax_lanes"]
        got = relax.relax_lanes(*args, op=op)
        assert relax.LAUNCHES["relax_lanes"] == before + 1
        _same(got, relax.relax_lanes_plain(*args, op=op))
        _check_apply_relax(dev, op, (_in_domain(op, args[0]), *args[1:]),
                           _running_mask(rng, n, dev))
    g = rmat_graph(scale=10, weighted=True, seed=3, device=dev)
    nodes = np.sort(rng.choice(g.num_nodes, 300, replace=False))
    f = torch.from_numpy(nodes.astype(np.int32)).to(dev)
    deg = g.row_ptr[f + 1] - g.row_ptr[f]
    prefix = torch.cumsum(deg, 0, dtype=torch.int32)
    dist = _with_extremes(rng, _lanes(rng, op, g.num_nodes, 1, dev)[0])
    args = (dist, prefix, prefix - deg, g.row_ptr[f], f, g.col, g.wt)
    cap = int(prefix[-1]) + 100
    before = relax.LAUNCHES["wd_relax_lanes"]
    got = relax.wd_relax_lanes(*args, cap_work=cap, op=op)
    assert relax.LAUNCHES["wd_relax_lanes"] == before + 1
    _same(got, relax.wd_relax_lanes_plain(*args, cap_work=cap, op=op))
    _check_wd_apply_relax(op, (_in_domain(op, dist), *args[1:]), cap,
                          _running_mask(rng, g.num_nodes, dev))
    _, _, dist_t, front_t = _union_case(g, rng, op, [300, 0, 17, 90, 300],
                                        dev)
    tables = multi_source.union_tables(g, front_t.any(1), g.num_nodes)
    uargs = (dist_t, front_t, *tables, g.col, g.wt)
    before = relax.LAUNCHES["wd_relax_lanes_batch"]
    got = relax.wd_apply_relax_union(*uargs, cap_work=g.num_edges,
                                     max_lanes=int(tables[0][-1]), op=op)
    assert relax.LAUNCHES["wd_relax_lanes_batch"] == before + 1
    _same(got, relax.wd_apply_relax_union_plain(
        *uargs, cap_work=g.num_edges, op=op))


#: (strategy, its kwargs) of the engine runs held card against CPU
ENGINE_RUNS = {"WD": ("WD", {}), "BS": ("BS", {}), "HP": ("HP", {}),
               "AD": ("AD", {}), "EP": ("EP", {}),
               "EP-unchunked": ("EP", {"chunked": False}), "NS": ("NS", {})}


def _trace(r):
    return [(s.frontier_size, s.edges_processed, s.sub_iterations, s.kernel)
            for s in r.iter_stats]


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
def test_engine_on_the_card_matches_cpu(dev, run):
    strategy, kwargs = ENGINE_RUNS[run]
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    src = int(g.degrees.argmax())
    for fn in (sssp, bfs):
        a = fn(g, src, strategy=strategy, device=dev, **kwargs)
        b = fn(g, src, strategy=strategy, device="cpu", **kwargs)
        assert a.device == "cuda" and b.device == "cpu"
        np.testing.assert_array_equal(a.dist, b.dist)
        assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                                   b.edges_relaxed)
        assert _trace(a) == _trace(b)
        assert a.state_bytes == b.state_bytes


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
def test_custom_operator_engine_on_the_card_matches_cpu(dev, run):
    """``engine.run`` with the penalty operator, stepped and fused, on the
    card equals the CPU's run: its B1/B2 (stepped) or its fused kernel
    (fused) built for it."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    strategy, kwargs = ENGINE_RUNS[run]
    op = CUSTOM_OPS["penalty"]
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    src = int(g.degrees.argmax())
    # the unchunked EP push has no fused lowering
    for mode in ("stepped", "fused")[:1 if run == "EP-unchunked" else 2]:
        a, b = (engine.run(g, src, make_strategy(strategy, **kwargs),
                           op=op, mode=mode, device=d) for d in (dev, "cpu"))
        np.testing.assert_array_equal(a.dist, b.dist)
        assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                                   b.edges_relaxed)


def _symmetrized(g):
    src = np.repeat(np.arange(g.num_nodes), g.degrees.numpy())
    dst = g.col.numpy()
    return CSRGraph.from_edges(np.concatenate([src, dst]),
                               np.concatenate([dst, src]), None, g.num_nodes,
                               dedup=True, device="cpu")


@pytest.mark.parametrize("strategy", ["BS", "WD", "NS", "HP", "AD"])
def test_connected_components_on_the_card_matches_cpu(dev, strategy):
    g = _symmetrized(rmat_graph(scale=12, weighted=False, seed=3,
                                device="cpu"))
    a = connected_components(g, strategy=strategy, device=dev)
    b = connected_components(g, strategy=strategy, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert (a <= np.arange(g.num_nodes)).all() and (a[a] == a).all()


@pytest.mark.parametrize("strategy", ["BS", "EP", "WD", "NS", "HP", "AD"])
def test_widest_path_on_the_card_matches_cpu(dev, strategy):
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    src = int(g.degrees.argmax())
    a = widest_path(g, src, strategy=strategy, device=dev)
    b = widest_path(g, src, strategy=strategy, device="cpu")
    np.testing.assert_array_equal(a.dist, b.dist)
    assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                               b.edges_relaxed)
    np.testing.assert_array_equal(a.dist, reference_widest(g, src))


# ---------------------------------------------------------------------------
# the fused fixed point: one launch a traversal, equal to its plain version
# ---------------------------------------------------------------------------

#: (strategy, its kwargs) of the fused runs: the defaults, and HP and AD
#: with thresholds that force HP's tiles and tail (and AD's HP branch) at
#: rmat12
FUSED_RUNS = {"BS": ("BS", {}), "WD": ("WD", {}), "HP": ("HP", {}),
              "HP-tiles": ("HP", {"switch_threshold": 16, "mdt": 4}),
              "EP": ("EP", {}), "NS": ("NS", {}), "AD": ("AD", {}),
              "AD-all": ("AD", {"small_frontier": 8,
                                "hp_edges_threshold": 256, "mdt": 4})}


def _fused_pair(g, strategy, kwargs, op, source, max_iterations):
    """The fused kernel and its plain version on the same card tensors;
    returns both results and the kernel launches of the kernel's run."""
    from repro_torch.core import fused as core_fused
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import fused as kernel_fused
    strat = make_strategy(strategy, **kwargs)
    plan = core_fused._plan(strat, strat.setup(g), g)
    n = plan.graph.num_nodes
    dist = torch.full((n,), op.identity, dtype=op.dtype, device=g.device)
    dist[source] = op.seed(source)
    mask = torch.zeros(n, dtype=torch.bool, device=g.device)
    mask[source] = True
    args = (plan.kernel, plan.graph, plan.aux, dist, mask)
    kw = dict(op=op, sched=plan.sched, max_iterations=max_iterations)
    before = dict(relax.LAUNCHES)
    got = kernel_fused.fixed_point(*args, **kw)
    launched = {k: relax.LAUNCHES[k] - before[k] for k in before}
    want = core_fused._fixed_point_plain(*args, **kw)
    assert torch.equal(dist, args[3]) and mask.sum() == 1   # inputs kept
    return got, want, launched


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("run", list(FUSED_RUNS))
def test_fused_kernel_matches_plain(dev, run, opname):
    """Every strategy and built-in operator: the kernel's (dist,
    iterations, edges, AD's choices) equal the plain loop's on the same
    card tensors, in one fused launch and no B1/B2 launch.  reach_count
    (add) grows without bound on rmat's cycles, so it runs 6 iterations."""
    strategy, kwargs = FUSED_RUNS[run]
    op = operators.OPERATORS[opname]
    g = rmat_graph(scale=12, weighted=True, seed=1, device=dev)
    source = int(g.degrees.argmax())
    got, want, launched = _fused_pair(
        g, strategy, kwargs, op, source,
        6 if opname == "reach_count" else 100000)
    assert torch.equal(got[0], want[0])
    assert got[1:] == want[1:] and got[1] > 1
    assert launched["fused_fixed_point"] == 1
    assert launched["relax_lanes"] == launched["wd_relax_lanes"] == 0
    if run == "AD-all":
        assert sum(c > 0 for c in got[3]) >= 2, got[3]


@pytest.mark.parametrize("run", list(FUSED_RUNS))
def test_fused_engine_on_the_card_matches_cpu_and_stepped(dev, run):
    """``mode="fused"`` through ``sssp``/``bfs`` on the card equals the
    CPU's fused run and the card's stepped run, AD's choices included,
    with one fused launch a traversal."""
    strategy, kwargs = FUSED_RUNS[run]
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    src = int(g.degrees.argmax())
    for fn in (sssp, bfs):
        before = relax.LAUNCHES["fused_fixed_point"]
        a = fn(g, src, strategy=strategy, device=dev, mode="fused", **kwargs)
        assert relax.LAUNCHES["fused_fixed_point"] == before + 1
        b = fn(g, src, strategy=strategy, device="cpu", mode="fused",
               **kwargs)
        c = fn(g, src, strategy=strategy, device=dev, **kwargs)
        assert a.mode == "fused" and a.iter_stats == []
        for other in (b, c):
            np.testing.assert_array_equal(a.dist, other.dist)
            assert (a.iterations, a.edges_relaxed) == (other.iterations,
                                                       other.edges_relaxed)


#: tail widths of the one-block BS/NS columns: none, a lone slot, a mid
#: start at rmat12, and the default, which is the widest
TAIL_WIDTHS = [0, 1, 16, 1024]


@pytest.mark.parametrize("width", TAIL_WIDTHS)
@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("run", ["BS", "NS", "AD-all"])
def test_fused_tail_matches_plain(dev, monkeypatch, run, opname, width):
    """BS, NS and AD (taking BS, WD and HP) at every tail width: the
    kernel's (dist, iterations, edges, choices) and its grid-wide and
    one-block chunks equal the plain loop's, for all four operators (add's
    two-barrier chunk and copy-back included).  Width 0 runs no column in
    one block; 16 starts the tail mid-iteration in wide frontiers and at
    column 0 in narrow ones."""
    from repro_torch.kernels import fused as kernel_fused
    monkeypatch.setattr(kernel_fused, "TAIL_WIDTH", width)
    strategy, kwargs = FUSED_RUNS[run]
    op = operators.OPERATORS[opname]
    g = rmat_graph(scale=12, weighted=True, seed=1, device=dev)
    got, want, launched = _fused_pair(
        g, strategy, kwargs, op, int(g.degrees.argmax()),
        6 if opname == "reach_count" else 100000)
    assert torch.equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert launched["fused_fixed_point"] == 1
    chunks = got[4]
    assert chunks.barriers > chunks.grid
    if width == 0:
        assert chunks.block == 0
    elif width >= 16 and run != "AD-all":
        assert chunks.block > 0
    if width == 16 and run == "BS":
        assert chunks.grid > 0


def _hub_graph(dev, hubs: int = 8, leaves: int = 40):
    """Node 0 reaches hubs 1..H (weights 1000 h); hub h has 10 h + 5
    edges, one of them (at position 9 h + 1) to hub h + 1 with weight 1
    and the rest to leaves.  In the second iteration every hub is in the
    frontier, and each hub's improvement of the next hub lands in a column
    before the one that relaxes the next hub's own chain edge: the values
    chain across columns, inside the one-block tail."""
    src, dst, wt = [], [], []
    for h in range(1, hubs + 1):
        src.append(0)
        dst.append(h)
        wt.append(1000 * h)
    first_leaf = hubs + 1
    for h in range(1, hubs + 1):
        for pos in range(10 * h + 5):
            src.append(h)
            if pos == 9 * h + 1 and h < hubs:
                dst.append(h + 1)
                wt.append(1)
            else:
                dst.append(first_leaf + (h * 7 + pos) % leaves)
                wt.append(pos % 13 + 1)
    return CSRGraph.from_edges(np.array(src), np.array(dst), np.array(wt),
                               first_leaf + leaves, device=dev)


@pytest.mark.parametrize("width", [0, 4, 8, 1024])
@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("strategy", ["BS", "AD"])
def test_fused_tail_chains_hub_values(dev, monkeypatch, strategy, opname,
                                      width):
    """Hubs in one frontier improving each other across columns: the
    kernel equals the plain loop and, for shortest_path, the stepped run
    on the card.  Width 4 starts the tail at column 64 (three hubs of
    degree > 64; hub 7's chain edge is column 64, after hub 6's at 55 in
    the grid-wide part), 8 at column 0, 0 never."""
    from repro_torch.kernels import fused as kernel_fused
    monkeypatch.setattr(kernel_fused, "TAIL_WIDTH", width)
    op = operators.OPERATORS[opname]
    g = _hub_graph(dev)
    got, want, _ = _fused_pair(g, strategy, {}, op, 0,
                               8 if opname == "reach_count" else 100000)
    assert torch.equal(got[0], want[0])
    assert got[1:] == want[1:]
    if width and strategy == "BS":
        assert got[4].block > 0
    if width == 4 and strategy == "BS":
        assert got[4].grid > 0
    if opname == "shortest_path":
        fused = sssp(g, 0, strategy=strategy, device=dev, mode="fused")
        stepped = sssp(g, 0, strategy=strategy, device=dev)
        np.testing.assert_array_equal(fused.dist, stepped.dist)
        np.testing.assert_array_equal(fused.dist, got[0].cpu().numpy())
        assert (fused.iterations, fused.edges_relaxed) == (
            stepped.iterations, stepped.edges_relaxed)
        # the chain: hub h + 1 is reached through hub h at 1000 + h
        assert fused.dist[1:9].tolist() == [1000 + h for h in range(8)]


def _layered_dag(dev, layers: int = 6, width: int = 40, seed: int = 3):
    """A DAG of ``layers`` layers of ``width`` nodes; every node of layer
    i has 1-60 edges into layer i + 1 (duplicates kept): reach_count's
    add converges after ``layers`` iterations."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for layer in range(layers - 1):
        for u in range(width):
            k = int(rng.integers(1, 61))
            src += [layer * width + u] * k
            dst += (layer * width + width
                    + rng.integers(0, width, k)).tolist()
    return CSRGraph.from_edges(np.array(src), np.array(dst), None,
                               layers * width, device=dev)


@pytest.mark.parametrize("width", [0, 8, 1024])
@pytest.mark.parametrize("strategy", ["BS", "NS"])
def test_fused_tail_reach_count_on_a_dag(dev, monkeypatch, strategy, width):
    """reach_count (add: two barriers a grid-wide chunk, a copy-back in
    the one-block tail) to its fixed point on a layered DAG: the kernel
    equals the plain loop and the stepped run on the card."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import fused as kernel_fused
    monkeypatch.setattr(kernel_fused, "TAIL_WIDTH", width)
    op = operators.reach_count
    g = _layered_dag(dev)
    got, want, _ = _fused_pair(g, strategy, {}, op, 0, 100000)
    assert torch.equal(got[0], want[0])
    assert got[1:] == want[1:] and got[1] == 6
    assert (got[4].block > 0) == (width > 0)
    stepped = engine.run(g, 0, make_strategy(strategy), op=op, device=dev)
    # NS: the split graph's first N values are the original nodes'
    np.testing.assert_array_equal(
        stepped.dist, got[0][:g.num_nodes].cpu().numpy())


#: tail widths of the delta mode: every stage grid-wide, narrow rounds of
#: at most 8 or 16 nodes (a mix of narrow and grid-wide rounds), and the
#: default
DELTA_WIDTHS = [0, 8, 16, 1024]


def _delta_graphs(dev):
    """Road side 128 (a high-diameter grid) and rmat scale 12 (power law),
    each with a source of high degree."""
    from repro_torch.data import road_grid_graph
    road = road_grid_graph(side=128, weighted=True, seed=4, device=dev)
    rmat = rmat_graph(scale=12, weighted=True, seed=1, device=dev)
    return {"road128": (road, 128 * 64 + 17),
            "rmat12": (rmat, int(rmat.degrees.argmax()))}


@pytest.mark.parametrize("width", DELTA_WIDTHS)
@pytest.mark.parametrize("strategy", ["BS", "WD", "NS", "HP", "AD"])
def test_fused_delta_tail_matches_plain(dev, monkeypatch, strategy, width):
    """The delta mode at every tail width on road side 128 and rmat scale
    12, three operators, auto Δ and Δ = 25: equal to the plain epoch loop
    in values, mask, epochs, rounds, edges, bucket, count and the split of
    rounds between the grid and one block.  Width 0 runs no round in one
    block and pays at least a grid barrier a round; NS's rounds stay
    grid-wide at every width."""
    from repro_torch.kernels import fused as kernel_fused
    monkeypatch.setattr(kernel_fused, "TAIL_WIDTH", width)
    for gname, (g, source) in _delta_graphs(dev).items():
        for opname in ("shortest_path", "min_label", "widest_path"):
            for delta in (None, 25):
                _, got, want, launched = _delta_pair(
                    g, strategy, operators.OPERATORS[opname], source, delta,
                    100000)
                assert torch.equal(got[0], want[0]), (gname, opname, delta)
                assert torch.equal(got[1], want[1])
                assert got[2:] == want[2:], (gname, opname, delta)
                assert launched["fused_fixed_point"] == 1
                rounds = got[7]
                assert rounds.grid + rounds.narrow == got[3]
                assert rounds.barriers >= rounds.grid
                if width == 0 or strategy == "NS":
                    assert rounds.narrow == 0
                elif gname == "road128" and width == 1024:
                    assert rounds.narrow > 0


@pytest.mark.parametrize("strategy", ["BS", "WD", "HP", "AD"])
def test_fused_delta_narrow_rounds_save_barriers(dev, monkeypatch,
                                                 strategy):
    """Road side 128 at the auto Δ and Δ = 25: the default width runs most
    rounds in one block, the same bits as width 0, and saves at least a
    grid barrier for each round it runs there."""
    from repro_torch.kernels import fused as kernel_fused
    g, source = _delta_graphs(dev)["road128"]
    for delta in (None, 25):
        runs = {}
        for width in (0, 1024):
            monkeypatch.setattr(kernel_fused, "TAIL_WIDTH", width)
            runs[width] = _delta_pair(g, strategy, operators.shortest_path,
                                      source, delta, 100000)[1]
        assert torch.equal(runs[0][0], runs[1024][0])
        assert runs[0][2:7] == runs[1024][2:7]
        narrow = runs[1024][7]
        assert narrow.narrow > 0
        assert narrow.barriers <= runs[0][7].barriers - narrow.narrow


@pytest.mark.parametrize("width", [0, 8, 1024])
def test_delta_stepped_fused_and_batch_agree_on_the_card(dev, monkeypatch,
                                                         width):
    """Road side 128 on the card: the stepped delta run (a launch an
    epoch) equals the fused one (values, epochs, rounds, edges, the split
    of rounds between the grid and one block) and the
    K = 8 fused delta batch equals its eight single runs, at every tail
    width, for the auto Δ and Δ = 25."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import fused as kernel_fused
    monkeypatch.setattr(kernel_fused, "TAIL_WIDTH", width)
    g, source = _delta_graphs(dev)["road128"]
    sources = g.degrees.cpu().numpy().argsort()[::-1][:8].astype(np.int32)
    for delta in (None, 25):
        runs = [engine.run(g, source, make_strategy("WD"), mode=mode,
                           schedule="delta", delta=delta, device=dev)
                for mode in ("stepped", "fused")]
        np.testing.assert_array_equal(runs[0].dist, runs[1].dist)
        assert (runs[0].iterations, runs[0].relax_rounds,
                runs[0].edges_relaxed) == (runs[1].iterations,
                                           runs[1].relax_rounds,
                                           runs[1].edges_relaxed)
        assert runs[0].round_split == runs[1].round_split
        before = relax.LAUNCHES["fused_fixed_point"]
        batch = engine.run_batch(g, sources, mode="fused", schedule="delta",
                                 delta=delta, device=dev)
        assert relax.LAUNCHES["fused_fixed_point"] - before == 8
        singles = [engine.run(g, int(s), make_strategy("WD"), mode="fused",
                              schedule="delta", delta=delta, device=dev)
                   for s in sources]
        for row, r in zip(batch.dist, singles):
            np.testing.assert_array_equal(row, r.dist)
        assert batch.iterations == max(r.iterations for r in singles)
        assert batch.relax_rounds == max(r.relax_rounds for r in singles)
        assert batch.edges_relaxed == sum(r.edges_relaxed for r in singles)


def test_barrier_probe_runs(dev):
    """The barrier probe: k barriers and nothing else, counted apart."""
    from repro_torch.kernels import fused as kernel_fused
    from repro_torch.kernels._build import LAUNCHES
    before = LAUNCHES["barrier_probe"]
    for k in (0, 1, 1000):
        kernel_fused.barrier_probe(k, dev)
    torch.cuda.synchronize()
    assert LAUNCHES["barrier_probe"] == before + 3
    with pytest.raises(RuntimeError):
        kernel_fused.barrier_probe(-1, dev)


@pytest.mark.parametrize("strategy", ["BS", "WD", "NS", "HP", "AD"])
def test_fused_connected_components_on_the_card_matches_cpu(dev, strategy):
    g = _symmetrized(rmat_graph(scale=12, weighted=False, seed=3,
                                device="cpu"))
    a = connected_components(g, strategy=strategy, device=dev, mode="fused")
    b = connected_components(g, strategy=strategy, device="cpu")
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# batched queries (A8): B1's batch contract and the fused batch
# ---------------------------------------------------------------------------

def _union_case(g, rng, op, widths, dev):
    """Node-major ``dist_t``/``front_t`` of ``len(widths)`` rows, row r's
    frontier ``widths[r]`` random nodes (0: an empty row), half of each
    drawn from a shared pool, and random values."""
    from repro_torch.core import multi_source
    k, n = len(widths), g.num_nodes
    pool = rng.choice(n, max(widths), replace=False)
    mask = np.zeros((k, n), bool)
    for r, width in enumerate(widths):
        mask[r, pool[:width // 2]] = True
        mask[r, rng.choice(n, width - width // 2, replace=False)] = True
    dist = rng.integers(0, 60, (k, n)).astype(np.int32)
    if op.combine == "min":
        dist[rng.random((k, n)) < 0.4] = op.identity
    dist_b = torch.from_numpy(dist).to(dev)
    mask_b = torch.from_numpy(mask).to(dev)
    return (dist_b, mask_b, multi_source.to_node_major(dist_b, op.identity),
            multi_source.to_node_major(mask_b, False))


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("weighted", [True, False])
def test_wd_relax_lanes_batch_kernel_matches_plain(dev, opname, weighted):
    """B1's batch contract (the union frontier, node-major) against its
    plain version on the same card tensors and against the row-by-row
    oracle, K = 5 and 32: rows of different widths and an empty row,
    whole (no row table) and with one row cut by ``cap_work`` and every
    row by ``cap``; one launch each."""
    from repro_torch.core import multi_source
    op = operators.OPERATORS[opname]
    g = rmat_graph(scale=14, weighted=weighted, seed=1, device=dev)
    rng = np.random.default_rng(5)
    n = g.num_nodes
    for widths in ([3000, 0, 17, 900, 3000], [40 * r for r in range(32)]):
        k = len(widths)
        dist_b, mask_b, dist_t, front_t = _union_case(g, rng, op, widths,
                                                      dev)
        totals = torch.where(mask_b, g.degrees, 0).sum(1).tolist()
        widest = max(widths)
        for cap, cap_work, cut in ((widest, max(totals), False),
                                   (widest, max(totals) // 2 + 1, True),
                                   (widest // 3, max(totals), True)):
            ft = front_t.clone()
            if cap < widest:
                ft &= torch.cumsum(ft, 0, dtype=torch.int32) <= cap
            tables = multi_source.union_tables(g, ft.any(1),
                                               min(n, k * cap))
            row_excl = (multi_source.row_exclusive(ft, *tables[:2],
                                                   tables[3])
                        if cut else None)
            args = (dist_t, ft, *tables, g.col, g.wt)
            kw = dict(cap_work=cap_work, row_excl=row_excl, op=op)
            before = relax.LAUNCHES["wd_relax_lanes_batch"]
            got = relax.wd_apply_relax_union(*args, max_lanes=int(
                tables[0][-1]), **kw)
            assert relax.LAUNCHES["wd_relax_lanes_batch"] == before + 1
            _same(got, relax.wd_apply_relax_union_plain(*args, **kw))
            rows = relax.wd_apply_relax_batch_plain(
                dist_b, torch.zeros_like(mask_b),
                *multi_source.row_tables(g, mask_b, cap), g.col, g.wt,
                cap_work=cap_work, op=op)
            _same([multi_source.from_node_major(t, k) for t in got], rows)
            assert got[1].any() and not got[1][:, k:].any()
            if widths[1] == 0:
                assert not got[1][:, 1].any()


@pytest.mark.parametrize("case", ["zero-degree runs", "empty frontier",
                                  "off-tile"])
def test_find_offsets_kernel_wide_slice_and_empty(dev, case):
    """B3 where a tile's prefix slice is too wide to stage (runs of
    thousands of zero-degree slots), with no slot at all (every item
    ranks 0), and at a ``cap_work`` off the tile and past the total;
    against its plain version and ``torch.searchsorted``."""
    rng = np.random.default_rng(9)
    if case == "empty frontier":
        prefix, caps = torch.zeros(0, dtype=torch.int32, device=dev), (
            1, 2047, 2048, 100003)
    else:
        deg = rng.integers(0, 9, 200000)
        if case == "zero-degree runs":
            for lo, hi in ((100, 9100), (20000, 20001), (50000, 120000)):
                deg[lo:hi] = 0
        prefix = torch.from_numpy(np.cumsum(deg).astype(np.int32)).to(dev)
        total = int(prefix[-1])
        caps = (total, total + 5, 2049) if case == "off-tile" else (total,)
    for cap in caps:
        got = fo.find_offsets(prefix, cap)
        _same([got], [fo.find_offsets_plain(prefix, cap)])
        if prefix.numel():
            _same([got], [torch.searchsorted(
                prefix, torch.arange(cap, dtype=torch.int32, device=dev),
                right=True, out_int32=True)])
        else:
            assert not got.any()


@pytest.mark.parametrize("opname", OP_NAMES)
def test_fused_batch_kernel_matches_plain(dev, opname):
    """The fused batch (a launch of the fused kernel a row) against its
    plain loop on the same card tensors, duplicate and edgeless sources
    included, with no B1/B2 launch."""
    from repro_torch.core import fused as core_fused
    from repro_torch.core import multi_source
    from repro_torch.kernels import fused as kernel_fused
    from repro_torch.core.schedule import DEFAULT_SCHEDULE
    op = operators.OPERATORS[opname]
    g = rmat_graph(scale=12, weighted=True, seed=1, device=dev)
    deg = g.degrees.cpu().numpy()
    sources = np.array([int(deg.argmax()), 5, int(np.flatnonzero(deg == 0)[0]),
                        int(deg.argmax()), 77], np.int32)
    dist, mask = multi_source.init_batch(
        g.num_nodes, torch.from_numpy(sources).to(dev), op=op)
    kw = dict(op=op, sched=DEFAULT_SCHEDULE,
              max_iterations=6 if opname == "reach_count" else 100000)
    before = dict(relax.LAUNCHES)
    got = kernel_fused.batch_fixed_point(g, dist, mask, **kw)
    launched = {k: relax.LAUNCHES[k] - before[k] for k in before}
    want = core_fused._batch_fixed_point_plain(
        g, dist, mask, op=op, max_iterations=kw["max_iterations"])
    assert torch.equal(got[0], want[0])
    assert got[1:] == want[1:] and got[1] > 1
    assert launched["fused_fixed_point"] == len(sources)
    assert launched["relax_lanes"] == launched["wd_relax_lanes"] == 0
    assert launched["wd_relax_lanes_batch"] == 0


def test_fused_batch_rows_equal_single_runs(dev):
    """Each row of a fused batch is the single-source fused WD run of its
    source: the same values, the rows' maximum iterations and summed
    edges, one launch a row."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    g = rmat_graph(scale=12, weighted=True, seed=1, device=dev)
    sources = [int(g.degrees.argmax()), 1, 2, 3, 4]
    before = relax.LAUNCHES["fused_fixed_point"]
    batch = engine.run_batch(g, sources, mode="fused", device=dev)
    assert relax.LAUNCHES["fused_fixed_point"] == before + len(sources)
    single = [engine.run(g, s, make_strategy("WD"), mode="fused",
                         device=dev) for s in sources]
    np.testing.assert_array_equal(batch.dist,
                                  np.stack([r.dist for r in single]))
    assert batch.iterations == max(r.iterations for r in single)
    assert batch.edges_relaxed == sum(r.edges_relaxed for r in single)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("algo", ["sssp", "bfs"])
def test_run_batch_on_the_card_matches_cpu(dev, mode, algo):
    """``run_batch`` on the card equals the CPU in dist, iterations, edges
    and per-iteration stats, with one B1 batch launch an iteration
    (stepped) or one fused launch a row, the padded rows included (fused);
    ``pad_to`` included."""
    from repro_torch.algos import bfs_batch, sssp_batch
    fn = sssp_batch if algo == "sssp" else bfs_batch
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    sources = [int(g.degrees.argmax()), 0, 3, 17, 42, 3]
    before = dict(relax.LAUNCHES)
    a = fn(g, sources, mode=mode, device=dev, pad_to=8)
    launched = {k: relax.LAUNCHES[k] - before[k] for k in before}
    b = fn(g, sources, mode=mode, device="cpu", pad_to=8)
    np.testing.assert_array_equal(a.dist, b.dist)
    assert (a.iterations, a.edges_relaxed, a.pad_lanes) == (
        b.iterations, b.edges_relaxed, b.pad_lanes)
    assert [(s.frontier_size, s.edges_processed) for s in a.iter_stats] == [
        (s.frontier_size, s.edges_processed) for s in b.iter_stats]
    assert launched["wd_relax_lanes"] == launched["relax_lanes"] == 0
    if mode == "stepped":
        assert launched["wd_relax_lanes_batch"] == a.iterations
    else:
        assert launched["fused_fixed_point"] == 8


def test_graph_server_on_the_card_matches_cpu(dev):
    """The same stream through ``GraphServer`` on the card and the CPU:
    equal rows and stats, one fused launch a dispatched lane (a row of a
    batch)."""
    from repro_torch.serve import GraphServer, Request, SimulatedClock
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    outs = []
    for device in (dev, "cpu"):
        srv = GraphServer(clock=SimulatedClock(), max_batch=4, device=device)
        srv.load_graph("g", g)
        srv.warm("g", [1, 2])
        before = relax.LAUNCHES["fused_fixed_point"]
        warm_lanes = srv.stats()["lanes_dispatched"]
        for s in [5, 9, 1, 13, 2, 7, 11]:
            srv.submit(Request(source=s, graph="g"))
        done = srv.drain()
        stats = srv.stats()
        if device is dev:
            assert (relax.LAUNCHES["fused_fixed_point"] - before
                    == stats["lanes_dispatched"] - warm_lanes)
        outs.append(([(r.request.source, r.cached, r.batch_lanes,
                       r.dist.tobytes()) for r in done], stats))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# B4 flash attention and B5 SSD chunk against their plain versions
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # B, Hq, Hkv, Sq, Sk, hd — tests/test_kernels.py's shapes, ragged
    # lengths and the serving path's heads
    (1, 1, 1, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 2, 128, 512, 128),
    (2, 6, 3, 384, 384, 32),
    (1, 4, 2, 200, 200, 64),
    (1, 16, 8, 1000, 1000, 128),
    (1, 2, 1, 70, 130, 32),
    # lengths that cut the bf16 kernel's 64-row packed tiles and 64-key
    # tiles (1, 63, 65, 129, 1000), G = Hq/Hkv in {1, 2, 4}, Sq != Sk
    # (top-left causal) both ways, ragged Sk
    (1, 1, 1, 1, 1, 64),
    (1, 2, 1, 63, 63, 128),
    (1, 4, 1, 65, 65, 32),
    (1, 4, 2, 129, 129, 128),
    (2, 8, 2, 1000, 1000, 64),
    (1, 2, 1, 1, 129, 64),
    (1, 4, 1, 129, 65, 128),
    (1, 3, 3, 63, 1000, 32),
    (1, 16, 8, 1, 1000, 128),
    (1, 8, 2, 1000, 63, 64),
    # grids of more than a wave of blocks: the path's longest prompt and
    # S = 2048, ragged lengths, G = 2 and 4, Sq > Sk
    (1, 16, 8, 1781, 1781, 128),
    (1, 16, 8, 2048, 2048, 128),
    (2, 8, 2, 2100, 2100, 64),
    (4, 6, 3, 1100, 1100, 32),
    (1, 32, 8, 1100, 700, 64),
    # granite_moe_3b_a800m's prefill: G = 3, hd 64, S = 2048 and ragged
    (1, 24, 8, 2048, 2048, 64),
    (1, 24, 8, 1781, 1781, 64),
]


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(dev, shape, dtype, causal):
    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Sq, Sk, hd = shape
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(s, generator=g).to(dev, dtype) for s in
               [(B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)])
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    _close(got, want, 2e-6 if dtype == torch.float32 else 2e-2)


#: B4 at its other head-dim pairs: B, Hq, Hkv, Sq, Sk, hd, hd_v, causal.
#: MLA's prefill (q/k [nope 128; rope 64], v 128; 128 heads a KV head
#: each) at deepseek_v3_671b's full width and ragged, MLA at the smoke
#: width (48/32), and llama_3_2_vision_11b's cross-attention (32 query
#: heads over 8, 2048 text tokens over 1601 image tokens, non-causal)
ATTN_PAIR_CASES = [
    (1, 128, 128, 2048, 2048, 192, 128, True),
    (1, 16, 16, 1000, 1000, 192, 128, True),
    (1, 8, 8, 1, 77, 192, 128, False),
    (1, 4, 4, 65, 129, 192, 128, True),
    (2, 4, 4, 129, 129, 48, 32, True),
    (1, 4, 2, 65, 63, 48, 32, False),
    (1, 32, 8, 2048, 1601, 128, 128, False),
    (2, 4, 2, 40, 16, 32, 32, False),
]


@pytest.mark.parametrize("case", ATTN_PAIR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_mla_and_cross_shapes(dev, case, dtype):
    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Sq, Sk, hd, hd_v, causal = case
    g = torch.Generator().manual_seed(sum(case))
    q, k, v = (torch.randn(s, generator=g).to(dev, dtype) for s in
               [(B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd_v)])
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, hd_v)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    _close(got, want, 2e-6 if dtype == torch.float32 else 2e-2)
    scale = 0.07            # a scale of the caller's own
    _close(fa.flash_attention(q, k, v, causal=causal, scale=scale),
           fa.flash_attention_plain(q, k, v, causal=causal, scale=scale),
           2e-6 if dtype == torch.float32 else 2e-2)


def test_flash_attention_refuses_other_head_dim_pairs(dev):
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(1, 2, 8, 192, device=dev)
    before = fa.LAUNCHES["flash_attention"]
    for hd_v in (192, 64, 32):
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(q, q, torch.randn(1, 2, 8, hd_v, device=dev))
    assert fa.LAUNCHES["flash_attention"] == before


#: the backward kernels' cases: B, Hq, Hkv, Sq, Sk, hd, hd_v, causal.
#: Every head-dim pair of ``HEAD_DIMS``, G in {1, 2, 3, 4}, ragged and
#: unequal lengths both ways (cross-attention's form: non-causal over
#: ragged keys, G 4; causal G 3 over more keys than queries), and
#: qwen3_0_6b's training shape (B 4, 16 heads over 8, S 2048)
ATTN_BWD_CASES = [
    (1, 8, 2, 300, 177, 128, 128, False),
    (1, 6, 2, 150, 200, 64, 64, True),
    (2, 4, 2, 40, 40, 32, 32, True),
    (1, 3, 1, 65, 129, 32, 32, False),
    (1, 6, 2, 129, 65, 64, 64, True),
    (2, 6, 2, 200, 200, 64, 64, False),
    (1, 16, 8, 1000, 1000, 128, 128, True),
    (1, 4, 4, 63, 130, 128, 128, True),
    (2, 4, 2, 129, 129, 48, 32, True),
    (1, 8, 8, 100, 77, 192, 128, True),
    (1, 8, 8, 70, 300, 192, 128, False),
    (4, 16, 8, 2048, 2048, 128, 128, True),
]


def _bwd_inputs(case, dtype, dev):
    B, Hq, Hkv, Sq, Sk, hd, hd_v, _ = case
    g = torch.Generator().manual_seed(sum(case[:7]))
    return tuple(torch.randn(s, generator=g).to(dev, dtype) for s in
                 [(B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd_v),
                  (B, Hq, Sq, hd_v)])


def _close_scaled(got, want, tol):
    """|got - want| <= tol * max|want|, elementwise."""
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("case", ATTN_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(dev, case, dtype):
    """B4's backward kernels against ``flash_attention_bwd_plain`` on the
    same card tensors, at the forward kernel's ``lse``: each gradient
    within 1e-4 (f32) or 2e-2 (bf16) of its largest magnitude, and the
    same bits on a second call (no atomics, sums in a fixed order)."""
    from repro_torch.kernels import flash_attention as fa
    causal = case[-1]
    q, k, v, do = _bwd_inputs(case, dtype, dev)
    o, lse = fa._flash_attention_cuda(q, k, v, causal, None, with_lse=True)
    o_plain, lse_plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                                  return_lse=True)
    _close_scaled(lse, lse_plain, 1e-5)
    before = fa.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert fa.LAUNCHES["flash_attention_bwd"] == before + 1
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for a, b in zip(got, want):
        _close_scaled(a, b, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_never_runs_the_plain_version(dev, dtype,
                                                         monkeypatch):
    """A CUDA input of either dtype goes through the backward kernels: with
    the plain backward made to raise, the wrapper still returns one
    launch's gradients."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs((1, 4, 2, 70, 70, 64, 64, True), dtype, dev)
    o, lse = fa._flash_attention_cuda(q, k, v, True, None, with_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)

    def forbidden(*args, **kwargs):
        raise AssertionError("a card tensor reached the plain backward")
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", forbidden)
    before = fa.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert fa.LAUNCHES["flash_attention_bwd"] == before + 1
    for a, b in zip(got, want):
        _close_scaled(a, b, 1e-4 if dtype == torch.float32 else 2e-2)


def test_flash_attention_bwd_refuses_misaligned_bf16(dev):
    """The bf16 backward kernels copy rows in 16-byte pieces: a bf16
    ``dout`` that starts off a 16-byte boundary raises before a launch."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs((1, 2, 2, 16, 16, 32, 32, True),
                              torch.bfloat16, dev)
    o, lse = fa._flash_attention_cuda(q, k, v, True, None, with_lse=True)
    shifted = torch.empty(do.numel() + 1, dtype=do.dtype,
                          device=dev)[1:].view_as(do)
    shifted.copy_(do)
    before = fa.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd(q, k, v, o, lse, shifted)
    assert fa.LAUNCHES["flash_attention_bwd"] == before


def test_flash_attention_bwd_refuses_more_tiles_than_its_grid(dev):
    """The bf16 backward kernels' grids take the 64-key and 64-packed-row
    tiles as their z (at most 65535): more keys raise before a launch."""
    from repro_torch.kernels import flash_attention as fa
    Sk = 64 * 65535 + 1
    q, o, do = (torch.zeros(1, 1, 1, 32, dtype=torch.bfloat16, device=dev)
                for _ in range(3))
    k, v = (torch.zeros(1, 1, Sk, 32, dtype=torch.bfloat16, device=dev)
            for _ in range(2))
    lse = torch.zeros(1, 1, 1, device=dev)
    before = fa.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError, match="65535 tiles"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    assert fa.LAUNCHES["flash_attention_bwd"] == before


@pytest.mark.parametrize("pair", [(32, 32), (64, 64), (128, 128), (48, 32),
                                  (192, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_leaves_the_output_unchanged(dev, pair, dtype):
    """The forward with and without its ``lse`` output: bit-identical
    outputs (the store is the only difference)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _bwd_inputs((2, 4, 2, 130, 130, *pair, True), dtype, dev)
    for causal in (True, False):
        plain = fa.flash_attention(q, k, v, causal=causal)
        with_lse, lse = fa._flash_attention_cuda(q, k, v, causal, None,
                                                 with_lse=True)
        assert torch.equal(plain, with_lse)
        assert lse.shape == q.shape[:3] and bool(torch.isfinite(lse).all())


def test_flash_attention_autograd_runs_the_kernels(dev):
    """``flash_attention`` on inputs that require gradients: one forward
    launch with ``lse`` and one backward launch, gradients equal to the
    plain backward's."""
    from repro_torch.kernels import flash_attention as fa
    case = (2, 6, 2, 100, 100, 64, 64, True)
    q, k, v, do = _bwd_inputs(case, torch.float32, dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    f0, b0 = fa.LAUNCHES["flash_attention"], fa.LAUNCHES["flash_attention_bwd"]
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.LAUNCHES["flash_attention"], fa.LAUNCHES["flash_attention_bwd"]
            ) == (f0 + 1, b0 + 1)
    o, lse = fa.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                      return_lse=True)
    want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        o, lse, do)
    for a, b in zip(grads, want):
        _close_scaled(a, b, 1e-4)


SSD_BWD_CASES = [
    # BN, c, H, P, N, decay: the smoke shape, ragged c, N/P not multiples
    # of 16, mamba2_780m's training shape (c 256, H 48, P 64, N 128), a
    # strong decay (a chunk's cum spans > 88), one head group (BN >= 132:
    # no partials to fold) and a last group of fewer heads (7 groups of 2
    # heads for 13)
    (3, 32, 4, 16, 16, 0.05), (2, 77, 3, 24, 40, 0.05),
    (2, 130, 5, 64, 128, 0.05), (1, 64, 2, 128, 128, 0.05),
    (16, 256, 48, 64, 128, 0.05), (2, 256, 8, 64, 128, 1.0),
    (140, 64, 3, 16, 16, 0.05), (20, 64, 13, 16, 24, 0.05),
]


def _ssd_bwd_inputs(case, dtype, dev):
    BN, c, H, P, N, decay = case
    g = torch.Generator().manual_seed(BN + c + H + P + N)
    xb = (torch.randn(BN, c, H, P, generator=g) * 0.1).to(dev, dtype)
    cum = torch.cumsum(-torch.randn(BN, c, H, generator=g).abs() * decay,
                       1).to(dev)
    Bm = (torch.randn(BN, c, N, generator=g) * 0.3).to(dev, dtype)
    Cm = (torch.randn(BN, c, N, generator=g) * 0.3).to(dev, dtype)
    dy = torch.randn(BN, c, H, P, generator=g).to(dev)
    ds = torch.randn(BN, H, N, P, generator=g).to(dev)
    return xb, cum, Bm, Cm, dy, ds


@pytest.mark.parametrize("case", SSD_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_bwd_kernel_matches_plain(dev, case, dtype):
    """B5's backward kernel against ``ssd_chunk_dual_bwd_plain`` on the
    same card tensors: each gradient within 1e-4 (f32) or 2e-2 (bf16) of
    its largest magnitude, finite under strong decay, and the same bits
    on a second call (the head groups' partials fold in a fixed order)."""
    from repro_torch.kernels import ssd_chunk as sc
    xb, cum, Bm, Cm, dy, ds = _ssd_bwd_inputs(case, dtype, dev)
    if case[-1] > 0.5:
        assert float(-cum[:, -1].min()) > 88
    before = sc.LAUNCHES["ssd_chunk_dual_bwd"]
    got = sc.ssd_chunk_dual_bwd(xb, cum, Bm, Cm, dy, ds)
    assert sc.LAUNCHES["ssd_chunk_dual_bwd"] == before + 1
    again = sc.ssd_chunk_dual_bwd(xb, cum, Bm, Cm, dy, ds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = sc.ssd_chunk_dual_bwd_plain(xb, cum, Bm, Cm, dy, ds)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        _close_scaled(a, b, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mamba2_780m"])
def test_smoke_train_step_on_the_card_equals_the_cpu(dev, arch):
    """One ``build_train_step`` step of the smoke config in float32 on the
    card and on the CPU from the same seeded weights: the loss within
    1e-5, every gradient leaf within 1e-4 (qwen3) or 2e-3 (mamba2) of its
    largest |g|, the parameters after AdamW within 1e-5; the card ran
    B4's or B5's forward and backward kernels.  Mamba-2's SSD layers
    amplify any float32 rounding: its gradients differ by 8e-4 of a
    leaf's largest |g| (measured on an H100 80GB HBM3, 700 W), as on the
    CPU the port's and the reference's float32 gradients lie 8.0e-4 and
    1.4e-4 from their common float64 run (``tests/test_torch_train.py``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_train_step
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    g = torch.Generator().manual_seed(9)
    batch = {k: torch.randint(2, cfg.vocab_size, (2, 64), generator=g)
             for k in ("tokens", "labels")}
    kernels = (("flash_attention", "flash_attention_bwd")
               if cfg.family != "ssm" else ("ssd_chunk_dual",
                                            "ssd_chunk_dual_bwd"))
    out = {}
    for device in (dev, torch.device("cpu")):
        before = {k: LAUNCHES[k] for k in kernels}
        step = build_train_step(cfg, ShapeSpec("t", 64, 2, "train"),
                                device=device)
        state = step.init_state()
        b = {k: v.to(device) for k, v in batch.items()}
        grads, metrics = step._grads(state["params"], b)
        grads = {k: v.float().cpu() for k, v in grads.items()}
        step.opt.update({k: v.to(device) for k, v in grads.items()},
                        state["opt"], state["params"])
        out[device.type] = (float(metrics["loss"]), grads, {
            k: p.detach().cpu() for k, p in state["params"].items()})
        launched = [LAUNCHES[k] - before[k] for k in kernels]
        assert all(n > 0 for n in launched) == (device.type == "cuda")
    (loss_g, grads_g, params_g), (loss_c, grads_c, params_c) = (
        out["cuda"], out["cpu"])
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for k, want in grads_c.items():
        _close_scaled(grads_g[k], want, 1e-4 if arch == "qwen3_0_6b"
                      else 2e-3)
        _close_scaled(params_g[k], params_c[k], 1e-5)


SSD_CASES = [
    # BN, c, H, P, N — tests/test_kernels.py's cases, a ragged c, the
    # serving path's heads
    (1, 32, 1, 16, 8), (3, 64, 4, 32, 16), (2, 128, 2, 64, 128),
    (2, 200, 3, 64, 128), (1, 77, 2, 16, 6), (2, 256, 48, 64, 128),
    # c in {1, 63, 64, 65, 200, 256}, N in {6, 16, 128}, P in {16, 64,
    # 128}, BN in {1, 2, 7}; H = 45 and 99 leave a partial head group
    # (the bf16 kernel takes 2 and 4 heads a block at these BN)
    (1, 1, 3, 16, 6), (2, 63, 5, 64, 16), (7, 64, 3, 128, 128),
    (1, 65, 48, 64, 128), (7, 200, 6, 16, 128), (1, 256, 5, 128, 16),
    (2, 256, 11, 64, 6), (7, 256, 45, 64, 128), (7, 256, 99, 64, 128),
    # N, P multiples of 8 but not 16 (padded tiles), and not of 8
    # (element-wise loads)
    (2, 64, 4, 24, 40), (1, 70, 3, 20, 20),
]


@pytest.mark.parametrize("shape", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_matches_plain(dev, shape, dtype):
    from repro_torch.kernels import ssd_chunk as sc
    BN, c, H, P, N = shape
    g = torch.Generator().manual_seed(sum(shape))
    xb = (torch.randn(BN, c, H, P, generator=g) * 0.1).to(dev, dtype)
    cum = torch.cumsum(-torch.randn(BN, c, H, generator=g).abs() * 0.05,
                       1).to(dev)
    Bm = (torch.randn(BN, c, N, generator=g) * 0.3).to(dev, dtype)
    Cm = (torch.randn(BN, c, N, generator=g) * 0.3).to(dev, dtype)
    before = sc.LAUNCHES["ssd_chunk_dual"]
    y, st = sc.ssd_chunk_dual(xb, cum, Bm, Cm)
    assert sc.LAUNCHES["ssd_chunk_dual"] == before + 1
    y2, st2 = sc.ssd_chunk_dual_plain(xb, cum, Bm, Cm)
    # bf16: ten times the measured error of the hi + lo split (a kernel
    # that kept only the bf16 hi term of CB∘L and B∘decay would miss)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    _close(y, y2, tol)
    _close(st, st2, tol)


def test_lm_kernel_wrappers_reject_bad_arguments(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    q = torch.randn(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 2, 8, 64, device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           q, q)
    xb = torch.randn(1, 8, 2, 256, device=dev)
    cum = torch.zeros(1, 8, 2, device=dev)
    Bm = torch.randn(1, 8, 16, device=dev)
    with pytest.raises(ValueError, match="P, N"):
        sc.ssd_chunk_dual(xb, cum, Bm, Bm)
    with pytest.raises(TypeError):
        sc.ssd_chunk_dual(xb[..., :16].contiguous(), cum.double(), Bm, Bm)
    # what the bf16 kernels cannot take raises: no other kernel runs it
    xb = torch.randn(1, 520, 2, 16, device=dev, dtype=torch.bfloat16)
    Bm = torch.randn(1, 520, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="c <= 512"):
        sc.ssd_chunk_dual(xb, torch.zeros(1, 520, 2, device=dev), Bm, Bm)
    q = torch.randn(1 + 2 * 8 * 64, device=dev, dtype=torch.bfloat16)[1:]
    q = q.view(1, 2, 8, 64)
    before = fa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, q, q)
    assert fa.LAUNCHES["flash_attention"] == before


def test_f32_kernels_take_views_off_a_16_byte_boundary(dev):
    """Only the bf16 kernels copy rows in 16-byte pieces: the f32 kernels
    load element by element and take a tensor at any start."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc

    def off(*shape):       # a contiguous view 4 bytes past an allocation
        n = 1
        for d in shape:
            n *= d
        return torch.randn(n + 1, device=dev)[1:].view(*shape)
    q = off(1, 2, 8, 64)
    _close(fa.flash_attention(q, q, q), fa.flash_attention_plain(q, q, q),
           2e-6)
    xb, Bm = off(1, 8, 2, 16), off(1, 8, 16)
    cum = torch.zeros(1, 8, 2, device=dev)
    for got, want in zip(sc.ssd_chunk_dual(xb, cum, Bm, Bm),
                         sc.ssd_chunk_dual_plain(xb, cum, Bm, Bm)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("arch,kernel", [("qwen3_0_6b", "flash_attention"),
                                         ("mamba2_780m", "ssd_chunk_dual")])
def test_serve_loop_on_the_card_matches_cpu(dev, arch, kernel):
    """A float32 smoke model served on the card: every prefill layer
    launches its kernel once, and the greedy tokens equal the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models.model import LanguageModel
    from repro_torch.runtime.serve import Request, ServeLoop
    cfg = get_config(arch).smoke(dtype="float32")

    def requests():
        rng = np.random.default_rng(0)
        return [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, n),
                        max_new_tokens=m)
                for i, (n, m) in enumerate([(70, 5), (33, 3), (100, 4)])]

    card = LanguageModel(cfg, seed=0, device=dev)
    before = LAUNCHES[kernel]
    got = ServeLoop(card, num_slots=2, max_len=128, eos_id=-1,
                    device=dev).run(requests())
    assert LAUNCHES[kernel] - before == cfg.num_layers * 3
    cpu = LanguageModel(cfg, seed=0, device="cpu")
    want = ServeLoop(cpu, num_slots=2, max_len=128, eos_id=-1,
                     device="cpu").run(requests())
    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(got, want):
        assert a.generated == b.generated


# ---------------------------------------------------------------------------
# delta-stepping (the fused kernel's delta mode) and measured AD
# ---------------------------------------------------------------------------

DELTA_STRATEGIES = ["BS", "WD", "NS", "HP", "AD"]


def _delta_pair(g, strategy, op, source, delta, max_iterations):
    """The fused kernel's delta mode and its plain loop on the same card
    tensors; returns both results and the launches of the kernel's run."""
    from repro_torch.core import priority
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import fused as kernel_fused
    strat = make_strategy(strategy)
    plan = priority.plan_delta(strat, strat.setup(g), g, op=op, delta=delta)
    n = plan.light.num_nodes
    dist = torch.full((n,), op.identity, dtype=op.dtype, device=g.device)
    dist[source] = op.seed(source)
    mask = torch.zeros(n, dtype=torch.bool, device=g.device)
    mask[source] = True
    args = (plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist, mask)
    kw = dict(op=op, sched=plan.sched, delta=plan.delta,
              max_iterations=max_iterations)
    before = dict(relax.LAUNCHES)
    got = kernel_fused.delta_fixed_point(*args, **kw)
    launched = {k: relax.LAUNCHES[k] - before[k] for k in before}
    want = priority._delta_fixed_point_plain(*args, **kw)
    assert mask.sum() == 1                           # inputs kept
    return plan, got, want, launched


@pytest.mark.parametrize("delta", [None, 25])
@pytest.mark.parametrize("opname", ["shortest_path", "min_label",
                                    "widest_path"])
@pytest.mark.parametrize("strategy", DELTA_STRATEGIES)
def test_fused_delta_kernel_matches_plain(dev, strategy, opname, delta):
    """Road side 128: the delta mode's (dist, mask, epochs, rounds, edges,
    last bucket, frontier count, rounds by kind) equal the plain epoch
    loop's on the same card tensors, whole and capped at one epoch (the
    stepped epoch), in one fused launch and no B1/B2 launch.  Δ = 25
    makes three quarters of the edges heavy for shortest_path."""
    from repro_torch.data import road_grid_graph
    op = operators.OPERATORS[opname]
    g = road_grid_graph(side=128, weighted=True, seed=4, device=dev)
    source = 128 * 64 + 17
    for cap in (100000, 1):
        plan, got, want, launched = _delta_pair(g, strategy, op, source,
                                                delta, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2:] == want[2:]
        assert launched["fused_fixed_point"] == 1
        assert launched["relax_lanes"] == launched["wd_relax_lanes"] == 0
    if delta == 25 and opname == "shortest_path":
        assert plan.heavy and got[3] > 1


@pytest.mark.parametrize("strategy", ["NS", "AD"])
def test_delta_components_from_every_node_on_the_card(dev, strategy):
    """Connected components under delta-stepping start with every node
    live, NS's split children too (their labels move when the kernel
    mirrors their parents): stepped and fused on the card equal the CPU on
    a symmetrized rmat12 and road side 64, and the kernel's delta mode
    equals its plain loop with every node seeded."""
    from repro_torch.core import priority
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import road_grid_graph
    from repro_torch.kernels import fused as kernel_fused
    graphs = [_symmetrized(rmat_graph(scale=12, weighted=False, seed=3,
                                      device="cpu")),
              road_grid_graph(side=64, weighted=True, seed=4, device="cpu")]
    for g in graphs:
        want = connected_components(g, strategy=strategy, schedule="delta",
                                    device="cpu")
        for mode in ("stepped", "fused"):
            got = connected_components(g, strategy=strategy, mode=mode,
                                       schedule="delta", device=dev)
            np.testing.assert_array_equal(got, want)
        gd = CSRGraph.from_arrays(g.row_ptr.numpy(), g.col.numpy(),
                                  None if g.wt is None else g.wt.numpy(),
                                  device=dev)
        strat = make_strategy(strategy)
        plan = priority.plan_delta(strat, strat.setup(gd), gd,
                                   op=operators.min_label)
        n = plan.light.num_nodes
        dist = torch.arange(n, dtype=torch.int32, device=dev)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        args = (plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist,
                mask)
        kw = dict(op=operators.min_label, sched=plan.sched, delta=plan.delta,
                  max_iterations=100000)
        got = kernel_fused.delta_fixed_point(*args, **kw)
        ref = priority._delta_fixed_point_plain(*args, **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert got[2:] == ref[2:]


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_delta_engine_on_the_card_matches_cpu(dev, mode):
    """sssp (auto Δ and Δ = 25), bfs and widest path with
    ``schedule="delta"`` on the card equal the CPU: values, epochs,
    rounds, edges and the stepped bucket trail, one launch an epoch
    (stepped) or a traversal (fused)."""
    from repro_torch.data import road_grid_graph
    g = road_grid_graph(side=64, weighted=True, seed=4, device="cpu")
    src = 64 * 32 + 5
    runs = [(sssp, dict(strategy="WD")), (sssp, dict(strategy="HP",
                                                     delta=25)),
            (bfs, dict(strategy="BS")), (widest_path, dict(strategy="NS"))]
    for fn, kw in runs:
        before = relax.LAUNCHES["fused_fixed_point"]
        a = fn(g, src, mode=mode, schedule="delta", device=dev, **kw)
        launches = relax.LAUNCHES["fused_fixed_point"] - before
        b = fn(g, src, mode=mode, schedule="delta", device="cpu", **kw)
        np.testing.assert_array_equal(a.dist, b.dist)
        assert (a.iterations, a.relax_rounds, a.edges_relaxed, a.delta) == (
            b.iterations, b.relax_rounds, b.edges_relaxed, b.delta)
        assert [(s.bucket, s.sub_iterations) for s in a.iter_stats] == [
            (s.bucket, s.sub_iterations) for s in b.iter_stats]
        assert launches == (1 if mode == "fused" else a.iterations)


def test_delta_batch_and_server_on_the_card_match_cpu(dev):
    """The delta batch launches one single-row delta traversal a row and
    equals the CPU; a fused GraphServer serves delta requests alike."""
    from repro_torch.algos import sssp_batch
    from repro_torch.data import road_grid_graph
    from repro_torch.serve import GraphServer, Request, SimulatedClock
    g = road_grid_graph(side=64, weighted=True, seed=4, device="cpu")
    sources = [0, 99, 2048, 4000, 99]
    before = relax.LAUNCHES["fused_fixed_point"]
    a = sssp_batch(g, sources, mode="fused", schedule="delta", delta=25,
                   device=dev)
    assert relax.LAUNCHES["fused_fixed_point"] - before == len(sources)
    b = sssp_batch(g, sources, mode="fused", schedule="delta", delta=25,
                   device="cpu")
    np.testing.assert_array_equal(a.dist, b.dist)
    assert (a.iterations, a.relax_rounds, a.edges_relaxed) == (
        b.iterations, b.relax_rounds, b.edges_relaxed)
    outs = []
    for device in (dev, "cpu"):
        srv = GraphServer(clock=SimulatedClock(), max_batch=4, device=device)
        srv.load_graph("g", g)
        for s in [5, 9, 1, 13]:
            srv.submit(Request(source=s, graph="g", schedule="delta"))
        srv.submit(Request(source=3, graph="g", schedule="delta", delta=9))
        done = srv.drain()
        outs.append(([(r.request.source, r.batch_lanes, r.dist.tobytes())
                      for r in done], srv.stats()))
    assert outs[0] == outs[1]


def _fma_flips(coeffs, n: int = 4000, seed: int = 0) -> list:
    """``(count, degree_sum)`` pairs whose argmin changes when each cost is
    contracted into FMAs instead of rounded after every operation."""
    rng = np.random.default_rng(seed)
    c = np.asarray(coeffs, np.float32)
    es = rng.integers(1, 2 ** 31 - 1, n).astype(np.float32)
    cn = rng.integers(1, 2 ** 20, n).astype(np.float32)
    sep = c[None, :, 0] + c[None, :, 1] * es[:, None] + (
        c[None, :, 2] * cn[:, None])
    f64 = np.float64
    inner = (f64(c[None, :, 1]) * f64(es[:, None])
             + f64(c[None, :, 0])).astype(np.float32)
    fma = (f64(c[None, :, 2]) * f64(cn[:, None]) + f64(inner)).astype(
        np.float32)
    flip = np.argmin(sep, 1) != np.argmin(fma, 1)
    return [(int(a), int(b)) for a, b in zip(cn[flip], es[flip])]


def test_ad_choice_probe_matches_choose(dev):
    """The fused kernel's measured selector (``ad_choice`` through its
    probe) equals ``CostModel.choose`` on a sweep with exact ties,
    degenerate frontiers, random pairs and pairs where an FMA would flip
    the argmin."""
    from repro_torch.core import costmodel
    from repro_torch.kernels import fused as kernel_fused
    rng = np.random.default_rng(5)
    near_tie = np.array([[0.0, 1.0 / 3.0, 0.0], [-1.0, 1.0 / 3.0, 0.0],
                         [1e12, 0.0, 0.0]])
    models = [near_tie, np.array([[1.0, 2.0, 3.0]] * 3),
              rng.normal(0, 1e-6, (3, 3)),
              np.array([[1e-5, 4e-8, 1e-9], [4e-5, 1e-8, 2e-8],
                        [9e-5, 2e-9, 5e-8]])]
    flips = _fma_flips(near_tie)
    assert len(flips) >= 10
    for coeffs in models:
        model = costmodel.CostModel(coeffs=coeffs)
        pairs = ([(0, 0), (0, 9), (9, 0), (1, 1), (5, 50)] + flips
                 + [(int(c), int(e)) for c, e in zip(
                     rng.integers(1, 2 ** 20, 500),
                     rng.integers(1, 2 ** 31 - 1, 500))])
        counts = torch.tensor([c for c, _ in pairs], dtype=torch.int32,
                              device=dev)
        sums = torch.tensor([e for _, e in pairs], dtype=torch.int32,
                            device=dev)
        got = kernel_fused.ad_choice_probe(model.coeff_array(), counts, sums)
        want = [costmodel.KERNELS.index(model.choose(c, e))
                for c, e in pairs]
        assert got.tolist() == want


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_measured_ad_on_the_card_matches_cpu(dev, mode):
    """AD with a cost model choosing among the kernels: the card equals
    the CPU in values, iterations, edges and ``kernel_counts``."""
    from repro_torch.core import costmodel, engine
    from repro_torch.core.strategies import make_strategy
    model = costmodel.CostModel(coeffs=np.array(
        [[1e-5, 4e-8, 1e-9], [4e-5, 1e-8, 2e-8], [9e-5, 2e-9, 5e-8]]))
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    src = int(g.degrees.argmax())
    out = []
    for device in (dev, "cpu"):
        strat = make_strategy("AD", cost_model=model)
        out.append((engine.run(g, src, strat, mode=mode, device=device),
                    strat.kernel_counts))
    (a, a_counts), (b, b_counts) = out
    np.testing.assert_array_equal(a.dist, b.dist)
    assert (a.iterations, a.edges_relaxed) == (b.iterations, b.edges_relaxed)
    assert a_counts == b_counts and len(a_counts) >= 2


def test_calibration_and_block_feasibility_on_the_card(dev, tmp_path):
    """Calibration on the card: one fused launch a timed step, a cache
    miss then a hit, finite coefficients; every block shape feasible,
    B4's and B5's backward kernels' included."""
    from repro_torch.core import costmodel
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    m1, hit1 = costmodel.calibrate(g, device=dev, cache_dir=str(tmp_path),
                                   repeats=2)
    m2, hit2 = costmodel.calibrate(g, device=dev, cache_dir=str(tmp_path),
                                   repeats=2)
    assert (hit1, hit2) == (False, True)
    assert np.isfinite(m1.coeffs).all()
    np.testing.assert_array_equal(m1.coeffs, m2.coeffs)
    assert m1.calibrated_on["device"] == torch.cuda.get_device_name(dev)
    rows = costmodel.block_feasibility(dev)
    assert set(rows) == set(costmodel.attr_calls())
    assert {row["kernel"] for row in rows.values()} == {
        "wd_relax_lanes", "relax_lanes", "wd_relax_union", "find_offsets",
        "fused_fixed_point", "fused_delta", "flash_attention",
        "ssd_chunk_dual", "flash_attention_bwd_dkdv",
        "flash_attention_bwd_dq", "ssd_chunk_dual_bwd"}
    for row in rows.values():
        assert row["feasible"] and row["blocks_per_sm"] >= 1
        # the bf16 B4/B5 forward kernels and B4's two bf16 backward
        # kernels run four mma.sync warps; every other kernel (B5's
        # backward and the f32 ones included) 256
        tensor_cores = (row.get("dtype") == "bfloat16" and row["kernel"] in
                        ("flash_attention", "ssd_chunk_dual",
                         "flash_attention_bwd_dkdv",
                         "flash_attention_bwd_dq"))
        assert row["threads"] == (128 if tensor_cores else 256), row
    # B4 at MLA's head dims: 128 threads (bf16) and 256 (f32); the bf16
    # kernel keeps two blocks a SM, the f32 one (115 KB) one
    mla = {dt: rows[f"flash_attention {dt} hd192/128"]
           for dt in ("bfloat16", "float32")}
    assert (mla["bfloat16"]["threads"], mla["float32"]["threads"]) == (
        128, 256)
    assert mla["bfloat16"]["blocks_per_sm"] >= 2
    assert {f"flash_attention {dt} hd48/32"
            for dt in ("bfloat16", "float32")} <= set(rows)


@pytest.mark.parametrize("method", ["padded", "sorted_block", "replicate",
                                    "multi_round"])
def test_moe_dispatch_on_the_card_matches_the_cpu(dev, method):
    """Each dispatch policy on card tensors (float32) against the same
    call on the CPU, at a capacity that drops: the same drop statistics
    and outputs within float32 noise."""
    from repro_torch.moe import balancing as mb
    g = torch.Generator().manual_seed(5)
    E, K, D, F = 8, 2, 64, 96
    x = torch.randn(2, 48, D, generator=g)
    w, ids, _ = mb.topk_route(torch.randn(2, 48, E, generator=g)
                              - torch.arange(E) * 0.5, K)
    ex = {"w_up": torch.randn(E, D, F, generator=g) / 8,
          "w_gate": torch.randn(E, D, F, generator=g) / 8,
          "w_down": torch.randn(E, F, D, generator=g) / 10}
    want, ws = mb.moe_dispatch(x, ids, w, ex, num_experts=E, capacity=8,
                               method=method)
    got, gs = mb.moe_dispatch(x.to(dev), ids.to(dev), w.to(dev),
                              {k: v.to(dev) for k, v in ex.items()},
                              num_experts=E, capacity=8, method=method)
    _close(got.cpu(), want, 1e-4)
    for key in ws:
        assert float(gs[key]) == float(ws[key]), key


@pytest.mark.parametrize("shards,serve_ep", [(2, False), (8, False),
                                             (8, True), (16, False)])
def test_sharded_moe_dispatch_on_the_card(dev, shards, serve_ep):
    """The expert-parallel dispatch over held shards on card tensors
    against the card's single-device ``padded`` dispatch at a capacity
    where nothing drops (float32: the same products summed in another
    order); 40 experts padded to 48 over 16 shards."""
    from repro_torch.core.shard import shard_group
    from repro_torch.moe import balancing as mb
    from repro_torch.moe import sharded as sh
    g = torch.Generator().manual_seed(shards)
    E, K, D, F, B, S = 40, 8, 64, 96, 2, 48
    x = torch.randn(B, S, D, generator=g).to(dev)
    logits = torch.randn(B, S, E, generator=g).to(dev)
    ex = {"w_up": torch.randn(E, D, F, generator=g) / 8,
          "w_gate": torch.randn(E, D, F, generator=g) / 8,
          "w_down": torch.randn(E, F, D, generator=g) / 10}
    ex = {k: v.to(dev) for k, v in ex.items()}
    w, ids, _ = mb.topk_route(logits, K)
    want, _ = mb.moe_dispatch(x, ids, w, ex, num_experts=E, capacity=S,
                              method="padded")
    wp, lg, ep = sh.pad_experts(ex, logits, E, shards)
    w2, ids2, _ = mb.topk_route(lg, K)
    assert torch.equal(ids2, ids)
    group = shard_group(shards, dev)
    if serve_ep:
        got = sh.ep_global_dispatch(x, ids2, w2, wp, group=group,
                                    num_experts=ep, capacity=B * S)
    else:
        got = sh.sharded_moe_dispatch(x, ids2, w2, wp, group=group,
                                      num_experts=ep, capacity=S)
    assert got.device == x.device
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch,overrides,tol", [
    ("deepseek_v3_671b", {}, 1e-3),
    ("llama_3_2_vision_11b", {}, 1e-2),
    ("musicgen_large", {}, 1e-2),
    ("granite_moe_3b_a800m", {"pad_heads": True}, 1e-3)])
def test_multimodal_and_mla_models_on_the_card_match_cpu(dev, arch,
                                                        overrides, tol):
    """A float32 smoke model on the card against the same weights on the
    CPU: a prefill (B4 once a layer, twice a cross layer) and three
    lockstep decode steps, logits within ``tol`` of the largest, and the
    greedy tokens equal wherever the CPU's two best logits lie further
    apart than that.  Vision and audio have no qk-norm: the CPU against
    itself with its embeddings nudged by 2^-22 moves their logits by
    5.8e-4 and 5.2e-4 of the largest (deepseek 1.3e-5, padded granite
    1.5e-4), and the card lands 1.8e-3 from the CPU on vision (measured
    on an H100 80GB HBM3, 700 W), so they are held to 1e-2.  Cross
    layers' gates at 0.5."""
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models.model import LanguageModel
    cfg = get_config(arch).smoke(dtype="float32", **overrides)
    cpu = LanguageModel(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for blk in cpu.layers:
            if "cross" in blk.tree():
                blk["cross"]["gate"].fill_(0.5)
    card = LanguageModel(cfg, seed=0, device="cpu").to_device(dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    shape = (2, 70) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    tok = torch.from_numpy(rng.integers(2, cfg.vocab_size, shape))
    vis = (torch.from_numpy(rng.standard_normal(
        (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
        if cfg.cross_attn_every else None)
    fed, runs = [], {}
    for name, model in (("cpu", cpu), ("card", card)):
        d = model.device
        kw = {} if vis is None else {"vision_embeds": vis.to(d)}
        before = LAUNCHES["flash_attention"]
        cache = model.new_cache(2, 80)
        logits, cache = model(tok.to(d), cache=cache, **kw)
        runs[name] = ([logits.float().cpu()],
                      LAUNCHES["flash_attention"] - before)
        for t in range(3):                  # the CPU's greedy tokens
            if name == "cpu":
                fed.append(logits[:, -1:].argmax(-1))
            logits, cache = model.decode_step(cache, fed[t].to(d), 70 + t)
            runs[name][0].append(logits.float().cpu())
    (got, launched), (want, _) = runs["card"], runs["cpu"]
    assert launched == cfg.num_layers + sum(
        cfg.layer_is_cross_attn(i) for i in range(cfg.num_layers))
    for a, b in zip(got, want):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * scale)
        top2 = b[:, -1].topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * tol * scale
        same = a[:, -1].argmax(-1) == b[:, -1].argmax(-1)
        assert bool(same[clear].all())


def test_smem_model_equals_the_card(dev):
    """The analysis pass's footprint model of every kernel's block
    (repro_torch.analysis.smem) equals the card's report: threads, static
    shared bytes and the dynamic bytes the launcher requests, with at
    least the blocks a SM the launch bounds promise."""
    from repro_torch.analysis import smem
    from repro_torch.core import costmodel
    for name, row in costmodel.block_feasibility(dev).items():
        fp = smem.row_footprint(row)
        assert (row["threads"], row["static_smem_bytes"],
                row["dynamic_smem_bytes"]) == (
            fp.threads, fp.static_smem, fp.dynamic_smem), name
        assert row["blocks_per_sm"] >= fp.min_blocks, name


# ---------------------------------------------------------------------------
# sharded fixed points (ROADMAP A11): every held shard's chunk is one B1 or
# B2 launch, folded before one apply_proposal
# ---------------------------------------------------------------------------

#: the SHARDABLE kernels; HP with thresholds that force its tiles and its
#: cursor-aware tail at rmat12
SHARD_RUNS = {"BS": ("BS", {}), "WD": ("WD", {}),
              "HP": ("HP", dict(switch_threshold=64, mdt=4)),
              "NS": ("NS", {})}


def _no_plain_relax(monkeypatch):
    """Make the plain B1/B2 raise, so a card run that reached them fails."""
    def forbidden(*args, **kwargs):
        raise AssertionError("a card run called a plain relax")
    for name in ("relax_lanes_plain", "wd_relax_lanes_plain"):
        monkeypatch.setattr(relax, name, forbidden)


def _count_folds(monkeypatch) -> list:
    """Record the held proposals of every ``ShardGroup.fold``."""
    from repro_torch.core import shard
    folds, real = [], shard.ShardGroup.fold

    def fold(self, op, proposals):
        folds.append(len(proposals))
        return real(self, op, proposals)
    monkeypatch.setattr(shard.ShardGroup, "fold", fold)
    return folds


def _shard_graph(opname):
    """rmat12 from its highest-degree node; reach_count on a layered DAG
    from node 0."""
    if opname == "reach_count":
        return _layered_dag("cpu"), 0
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    return g, int(g.degrees.argmax())


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("run", list(SHARD_RUNS))
def test_sharded_lockstep_on_the_card_matches_cpu(dev, monkeypatch, run,
                                                  opname):
    """Lockstep on the card equals the CPU in (dist, iterations, edges,
    rounds); each chunk launches B1 or B2 once a held shard (launches =
    the folds' proposals), no plain relax and no fused kernel."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    strategy, kwargs = SHARD_RUNS[run]
    g, src = _shard_graph(opname)
    for shards, method in ((2, "degree"), (3, "contiguous")):
        cpu = engine.run(g, src, make_strategy(strategy, **kwargs),
                         mode="fused", op=opname, shards=shards,
                         partition=method, device="cpu")
        with monkeypatch.context() as m:
            _no_plain_relax(m)
            folds = _count_folds(m)
            before = dict(relax.LAUNCHES)
            card = engine.run(g, src, make_strategy(strategy, **kwargs),
                              mode="fused", op=opname, shards=shards,
                              partition=method, device=dev)
            launched = {k: relax.LAUNCHES[k] - before[k] for k in before}
        np.testing.assert_array_equal(card.dist, cpu.dist)
        assert (card.iterations, card.edges_relaxed, card.relax_rounds) == (
            cpu.iterations, cpu.edges_relaxed, cpu.relax_rounds)
        assert set(folds) == {shards}
        assert (launched["wd_relax_lanes"] + launched["relax_lanes"]
                == sum(folds) > 0)
        assert launched["fused_fixed_point"] == 0
        if strategy == "WD":
            assert launched["wd_relax_lanes"] == shards * card.iterations
        if strategy in ("BS", "NS"):
            assert launched["wd_relax_lanes"] == 0


@pytest.mark.parametrize("opname", ["shortest_path", "min_label",
                                    "widest_path"])
@pytest.mark.parametrize("run", list(SHARD_RUNS))
def test_sharded_async_on_the_card_matches_cpu(dev, monkeypatch, run,
                                               opname):
    """Async shards on the card equal the CPU in values, epochs, rounds
    and edges (the same local loops run), with one fold an epoch and the
    card's B1/B2 only."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    strategy, kwargs = SHARD_RUNS[run]
    g, src = _shard_graph(opname)
    cpu = engine.run(g, src, make_strategy(strategy, **kwargs), mode="fused",
                     op=opname, shards=3, async_shards=True, device="cpu")
    with monkeypatch.context() as m:
        _no_plain_relax(m)
        folds = _count_folds(m)
        before = dict(relax.LAUNCHES)
        card = engine.run(g, src, make_strategy(strategy, **kwargs),
                          mode="fused", op=opname, shards=3,
                          async_shards=True, device=dev)
        launched = {k: relax.LAUNCHES[k] - before[k] for k in before}
    np.testing.assert_array_equal(card.dist, cpu.dist)
    assert (card.iterations, card.relax_rounds, card.edges_relaxed) == (
        cpu.iterations, cpu.relax_rounds, cpu.edges_relaxed)
    assert folds == [3] * card.iterations
    assert launched["wd_relax_lanes"] + launched["relax_lanes"] > 0


@pytest.mark.parametrize("opname", OP_NAMES)
def test_sharded_batch_on_the_card_matches_cpu(dev, monkeypatch, opname):
    """A sharded batch on the card equals the CPU; one B1 launch a live
    row and held shard an iteration (a row is live for its own single
    run's iterations)."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    g, src = _shard_graph(opname)
    sources = [src, 0, 3, 17, 3] if opname != "reach_count" else [0, 1, 40]
    cpu = engine.run_batch(g, sources, mode="fused", op=opname, shards=2,
                           device="cpu")
    rows = [engine.run(g, s, make_strategy("WD"), mode="fused", op=opname,
                       device="cpu").iterations for s in sources]
    with monkeypatch.context() as m:
        _no_plain_relax(m)
        before = dict(relax.LAUNCHES)
        card = engine.run_batch(g, sources, mode="fused", op=opname,
                                shards=2, device=dev)
        launched = {k: relax.LAUNCHES[k] - before[k] for k in before}
    np.testing.assert_array_equal(card.dist, cpu.dist)
    assert (card.iterations, card.edges_relaxed) == (cpu.iterations,
                                                     cpu.edges_relaxed)
    assert launched["wd_relax_lanes"] == 2 * sum(rows)
    assert launched["relax_lanes"] == launched["fused_fixed_point"] == 0


@pytest.mark.parametrize("shards", [2, 3])
def test_distributed_sssp_on_the_card_matches_cpu(dev, shards):
    """``distributed_sssp`` on the card equals the CPU and Dijkstra; B3
    ranks each shard's lanes, a launch a shard an iteration."""
    from repro_torch.core import dist, engine, shard
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    src = int(g.degrees.argmax())
    before = relax.LAUNCHES["find_offsets"]
    card = dist.distributed_sssp(g, src, shard.shard_group(shards, dev))
    launched = relax.LAUNCHES["find_offsets"] - before
    cpu = dist.distributed_sssp(g, src, shard.shard_group(shards, "cpu"))
    np.testing.assert_array_equal(card, cpu)
    np.testing.assert_array_equal(card, engine.reference_distances(g, src))
    assert launched > 0 and launched % shards == 0


# ---------------------------------------------------------------------------
# float32 operators: their own builds of B1, B2, B1's batch contract and the
# fused kernel, against the plain versions on CPU copies
# ---------------------------------------------------------------------------

#: the float32 operators of the card tests: SSSP in hundredths (a
#: multiply-add the card must not contract), the most reliable path (a
#: quotient), damped path counts (add), and a min whose update admits NaN
FLOAT_OPS = {
    "scaled_sssp": operators.EdgeOp(
        name="scaled_sssp", combine="min", identity=float(operators.INF),
        source_value=0.0, message=lambda v, w: v + w * 0.01,
        weight_additive=True, dtype=torch.float32),
    "reliable": operators.EdgeOp(
        name="reliable", combine="max", identity=0.0, source_value=1.0,
        message=lambda v, w: v * (w / (w + 1.0)), value_min=0,
        dtype=torch.float32),
    "damped": operators.EdgeOp(
        name="damped", combine="add", identity=0.0, source_value=1.0,
        message=lambda v, w: v * 0.5, dtype=torch.float32),
    "nan_min": operators.EdgeOp(
        name="nan_min", combine="min", identity=float("inf"),
        source_value=0.0, message=lambda v, w: v - w * 0.5,
        update=lambda cand, cur: (cand < cur) | (cand != cand),
        dtype=torch.float32),
}

#: float extremes planted among the values, as EXTREMES plants int32 ones:
#: both zeros, 2^30, NaN, infinities, subnormals and the largest floats;
#: add takes the non-negative ones that no order of its sum overflows
FLOAT_EXTREMES = (0.0, -0.0, 2.0 ** 30, float("nan"), float("inf"),
                  float("-inf"), 1e-45, -1e-40, 3.4e38, -3.4e38, -1.0)
ADD_EXTREMES = (0.0, -0.0, 2.0 ** 30, 1e-45, 1e-40, float("inf"))


def _float_values(rng, op, shape):
    """Random values of ``op``'s domain with a tenth planted extremes."""
    if op.combine == "max":
        a = rng.random(shape).astype(np.float32)
    else:
        a = (rng.random(shape) * 60).astype(np.float32)
        if op.combine == "min":
            a[rng.random(shape) < 0.4] = op.identity
    at = rng.random(shape) < 0.1
    pool = ADD_EXTREMES if op.combine == "add" else FLOAT_EXTREMES
    a[at] = rng.choice(np.array(pool, np.float32), int(at.sum()))
    return a


def _float_same(got, want, op):
    """Tensors of the card against the CPU's: bools and ints exactly;
    float32 values of min and max bit for bit and NaN for NaN (a NaN's
    payload is the hardware's), of add at rtol 1e-4 (the order of a float
    sum).  Returns the largest relative error of the float values."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype != torch.float32:
            assert torch.equal(a, b)
            continue
        an, bn = a.isnan(), b.isnan()
        assert torch.equal(an, bn)
        x, y = a[~an], b[~bn]
        if op.combine == "add":
            torch.testing.assert_close(x, y, rtol=1e-4, atol=0,
                                       equal_nan=False)
            fin = torch.isfinite(y) & (y != 0)
            if fin.any():
                worst = max(worst, float(((x - y).abs() / y.abs())[fin]
                                         .max()))
        else:
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    return worst


def _cpu(t):
    return None if t is None else t.cpu()


@pytest.mark.parametrize("opname", list(FLOAT_OPS))
def test_float_operator_kernels_match_plain(dev, opname):
    """B2 (both contracts), B1 (both) and B1's batch contract built for a
    float32 operator, against their plain versions on CPU copies (the
    card's torch may divide by a reciprocal): values with float extremes
    planted (the folds into dist: the values of the operator's domain),
    int32 weights with int32 extremes; one launch each."""
    from repro_torch.core import multi_source
    op = FLOAT_OPS[opname]
    rng = np.random.default_rng(29)
    for n, lanes in ((257, 2050), (5000, 100000)):
        _, src, dst, w, valid = _lanes(rng, operators.shortest_path, n,
                                       lanes, dev)
        dist = torch.from_numpy(_float_values(rng, op, n)).to(dev)
        args = (dist, src, dst, _with_extremes(rng, w), valid)
        before = relax.LAUNCHES["relax_lanes"]
        got = relax.relax_lanes(*args, op=op)
        assert relax.LAUNCHES["relax_lanes"] == before + 1
        _float_same(got, relax.relax_lanes_plain(
            *(_cpu(a) for a in args), op=op), op)
        mask = _running_mask(rng, n, dev)
        dist = _in_domain(op, dist)
        want = relax.apply_relax_plain(*(_cpu(a) for a in (dist, mask)),
                                       *(_cpu(a) for a in args[1:]), op=op)
        got = relax.apply_relax(dist, mask, *args[1:], op=op)
        assert relax.LAUNCHES["relax_lanes"] == before + 2
        _float_same(got, want, op)
    g = rmat_graph(scale=10, weighted=True, seed=3, device=dev)
    nodes = np.sort(rng.choice(g.num_nodes, 300, replace=False))
    f = torch.from_numpy(nodes.astype(np.int32)).to(dev)
    deg = g.row_ptr[f + 1] - g.row_ptr[f]
    prefix = torch.cumsum(deg, 0, dtype=torch.int32)
    dist = torch.from_numpy(_float_values(rng, op, g.num_nodes)).to(dev)
    wt = _with_extremes(rng, g.wt)
    args = (dist, prefix, prefix - deg, g.row_ptr[f], f, g.col, wt)
    cpu_args = tuple(_cpu(a) for a in args)
    cap = int(prefix[-1]) + 100
    before = relax.LAUNCHES["wd_relax_lanes"]
    got = relax.wd_relax_lanes(*args, cap_work=cap, op=op)
    assert relax.LAUNCHES["wd_relax_lanes"] == before + 1
    _float_same(got, relax.wd_relax_lanes_plain(*cpu_args, cap_work=cap,
                                                op=op), op)
    mask = _running_mask(rng, g.num_nodes, dev)
    dist = _in_domain(op, dist)
    want = relax.wd_apply_relax_plain(dist.cpu(), mask.cpu(), *cpu_args[1:],
                                      cap_work=cap, op=op)
    _float_same(relax.wd_apply_relax(dist, mask, *args[1:], cap_work=cap,
                                     op=op), want, op)
    k, n = 5, g.num_nodes
    mask_b = torch.from_numpy(rng.random((k, n)) < 0.05).to(dev)
    mask_b[1] = False
    dist_b = _in_domain(op, torch.from_numpy(
        _float_values(rng, op, (k, n))).to(dev))
    dist_t = multi_source.to_node_major(dist_b, op.identity)
    front_t = multi_source.to_node_major(mask_b, False)
    tables = multi_source.union_tables(g, front_t.any(1), g.num_nodes)
    uargs = (dist_t, front_t, *tables, g.col, wt)
    before = relax.LAUNCHES["wd_relax_lanes_batch"]
    got = relax.wd_apply_relax_union(*uargs, cap_work=g.num_edges,
                                     max_lanes=int(tables[0][-1]), op=op)
    assert relax.LAUNCHES["wd_relax_lanes_batch"] == before + 1
    _float_same(got, relax.wd_apply_relax_union_plain(
        *(_cpu(a) for a in uargs), cap_work=g.num_edges, op=op), op)


def test_float_fold_orders_zeros_and_keeps_nan(dev):
    """The card's float fold on a hand-made case: every lane into one
    destination, −0.0 and +0.0 candidates in both orders (min keeps −0.0,
    max +0.0), and a NaN candidate (admitted by nan_min's update) that no
    later candidate displaces."""
    op = FLOAT_OPS["nan_min"]
    for order in ([-0.0, 0.0, 5.0], [0.0, -0.0, 5.0],
                  [3.0, float("nan"), -7.0, 0.0]):
        lanes = len(order)
        dist = torch.tensor([float("inf")] + order, device=dev)
        src = torch.arange(1, lanes + 1, dtype=torch.int32, device=dev)
        dst = torch.zeros(lanes, dtype=torch.int32, device=dev)
        w = torch.zeros(lanes, dtype=torch.int32, device=dev)
        valid = torch.ones(lanes, dtype=torch.bool, device=dev)
        prop = relax.relax_lanes(dist, src, dst, w, valid, op=op)[0]
        want = relax.relax_lanes_plain(*(a.cpu() for a in (
            dist, src, dst, w, valid)), op=op)[0]
        _float_same([prop], [want], op)
        if any(x != x for x in order):
            assert bool(prop[0].isnan())
        else:
            assert float(prop[0]) == 0.0 and bool(prop[0].signbit())


def _float_graph(opname, dev):
    """rmat12 from its highest-degree node; damped path counts on the
    layered DAG from node 0."""
    if opname == "damped":
        return _layered_dag(dev), 0
    g = rmat_graph(scale=12, weighted=True, seed=1, device=dev)
    return g, int(g.degrees.argmax())


def _fused_float_pair(g, strategy, kwargs, op, source):
    """The fused kernel for a float operator and its plain loop on CPU
    copies; returns both and the kernel run's launches."""
    from repro_torch.core import fused as core_fused
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import fused as kernel_fused
    strat = make_strategy(strategy, **kwargs)
    plan = core_fused._plan(strat, strat.setup(g), g)
    n = plan.graph.num_nodes
    dist = torch.full((n,), op.identity, dtype=op.dtype, device=g.device)
    dist[source] = op.seed(source)
    mask = torch.zeros(n, dtype=torch.bool, device=g.device)
    mask[source] = True
    kw = dict(op=op, sched=plan.sched, max_iterations=100000)
    before = dict(relax.LAUNCHES)
    got = kernel_fused.fixed_point(plan.kernel, plan.graph, plan.aux, dist,
                                   mask, **kw)
    launched = {k: relax.LAUNCHES[k] - before[k] for k in before}
    want = core_fused._fixed_point_plain(
        plan.kernel, plan.graph.to("cpu"), _cpu(plan.aux), dist.cpu(),
        mask.cpu(), **kw)
    return got, want, launched


@pytest.mark.parametrize("opname", ["scaled_sssp", "reliable", "damped"])
@pytest.mark.parametrize("run", list(FUSED_RUNS))
def test_float_fused_kernel_matches_plain(dev, run, opname):
    """Every strategy: the float32 fused kernel's (dist, iterations,
    edges, AD's choices, chunks) equal the plain loop's on CPU copies,
    in one fused launch and no B1/B2 launch."""
    strategy, kwargs = FUSED_RUNS[run]
    op = FLOAT_OPS[opname]
    g, source = _float_graph(opname, dev)
    got, want, launched = _fused_float_pair(g, strategy, kwargs, op, source)
    _float_same([got[0]], [want[0]], op)
    assert got[1:] == want[1:]
    assert launched["fused_fixed_point"] == 1
    assert launched["relax_lanes"] == launched["wd_relax_lanes"] == 0


@pytest.mark.parametrize("delta", [None, 25])
@pytest.mark.parametrize("opname", ["scaled_sssp", "reliable"])
@pytest.mark.parametrize("strategy", ["BS", "WD", "NS", "HP", "AD"])
def test_float_fused_delta_kernel_matches_plain(dev, strategy, opname,
                                                delta):
    """Road side 128: the float32 delta mode's (dist, mask, epochs, rounds,
    edges, last bucket, frontier count, rounds by kind) equal the plain
    epoch loop's on CPU copies, whole and capped at one epoch, in one
    launch: the buckets of float values as worklist.bucket_index has
    them."""
    from repro_torch.core import priority
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import road_grid_graph
    from repro_torch.kernels import fused as kernel_fused
    op = FLOAT_OPS[opname]
    g = road_grid_graph(side=128, weighted=True, seed=4, device=dev)
    source = 128 * 64 + 17
    strat = make_strategy(strategy)
    plan = priority.plan_delta(strat, strat.setup(g), g, op=op, delta=delta)
    n = plan.light.num_nodes
    dist = torch.full((n,), op.identity, dtype=op.dtype, device=dev)
    dist[source] = op.seed(source)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[source] = True
    for cap in (100000, 1):
        kw = dict(op=op, sched=plan.sched, delta=plan.delta,
                  max_iterations=cap)
        before = relax.LAUNCHES["fused_fixed_point"]
        got = kernel_fused.delta_fixed_point(
            plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist, mask,
            **kw)
        assert relax.LAUNCHES["fused_fixed_point"] == before + 1
        heavy = plan.heavy_graph
        want = priority._delta_fixed_point_plain(
            plan.kernel, plan.light.to("cpu"),
            None if heavy is None else heavy.to("cpu"), _cpu(plan.aux),
            dist.cpu(), mask.cpu(), **kw)
        _float_same(got[:2], want[:2], op)
        assert got[2:] == want[2:]


@pytest.mark.parametrize("delta", [None, 25])
@pytest.mark.parametrize("strategy", ["BS", "WD", "NS"])
def test_float_delta_takes_a_nan_bucket_first(dev, strategy, delta):
    """A NaN admitted by a custom ``update`` under the float32 delta mode:
    the message is 0/0 on the edges of weight 33, and a NaN candidate
    improves every value but a NaN.  A NaN rank's bucket is INT32_MIN
    (``worklist.bucket_index``), so once a NaN appears the kernel's
    unsigned bucket key takes its bucket before every other, as the plain
    epoch loop's ``min_live_bucket`` does.  Road side 128: (dist, mask,
    epochs, rounds, edges, last bucket, frontier count, rounds by kind)
    equal the plain loop's on CPU copies, and the NaN has spread."""
    import dataclasses
    from repro_torch.core import priority
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import road_grid_graph
    from repro_torch.kernels import fused as kernel_fused
    op = dataclasses.replace(
        FLOAT_OPS["nan_min"], name="nan_at_33",
        message=lambda v, w: (v + w * 0.5) * (w - 33) / (w - 33),
        update=lambda cand, cur: (cand < cur) | ((cand != cand)
                                                 & (cur == cur)))
    g = road_grid_graph(side=128, weighted=True, seed=4, device=dev)
    source = 128 * 64 + 17
    strat = make_strategy(strategy)
    plan = priority.plan_delta(strat, strat.setup(g), g, op=op, delta=delta)
    n = plan.light.num_nodes
    dist = torch.full((n,), op.identity, dtype=op.dtype, device=dev)
    dist[source] = op.seed(source)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[source] = True
    kw = dict(op=op, sched=plan.sched, delta=plan.delta,
              max_iterations=100000)
    got = kernel_fused.delta_fixed_point(
        plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist, mask,
        **kw)
    heavy = plan.heavy_graph
    want = priority._delta_fixed_point_plain(
        plan.kernel, plan.light.to("cpu"),
        None if heavy is None else heavy.to("cpu"), _cpu(plan.aux),
        dist.cpu(), mask.cpu(), **kw)
    _float_same(got[:2], want[:2], op)
    assert got[2:] == want[2:]
    assert want[2] > 1 and int(want[0].isnan().sum()) > 1


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
@pytest.mark.parametrize("opname", ["scaled_sssp", "reliable", "damped"])
def test_float_engine_on_the_card_matches_cpu(dev, monkeypatch, opname, run):
    """``engine.run`` with a float32 operator, stepped and fused, on the
    card equals the CPU's run, and the card run reaches no plain relax:
    only the operator's own kernels launch."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    strategy, kwargs = ENGINE_RUNS[run]
    op = FLOAT_OPS[opname]
    g, src = _float_graph(opname, "cpu")
    for mode in ("stepped", "fused")[:1 if run == "EP-unchunked" else 2]:
        b = engine.run(g, src, make_strategy(strategy, **kwargs), op=op,
                       mode=mode, device="cpu")
        with monkeypatch.context() as m:
            _no_plain_relax(m)
            a = engine.run(g, src, make_strategy(strategy, **kwargs), op=op,
                           mode=mode, device=dev)
        assert a.dist.dtype == np.float32
        _float_same([torch.from_numpy(a.dist)], [torch.from_numpy(b.dist)],
                    op)
        assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                                   b.edges_relaxed)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("opname", ["scaled_sssp", "reliable"])
def test_float_batch_and_shards_on_the_card_match_cpu(dev, opname, mode):
    """A K = 8 batch (B1's union contract stepped, a fused launch a row
    fused) and a two-shard lockstep WD run with a float32 operator: the
    card equals the CPU."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    op = FLOAT_OPS[opname]
    g, src = _float_graph(opname, "cpu")
    sources = [src, 0, 3, 3, 100, 7, 2048, 4095]
    a, b = (engine.run_batch(g, sources, op=op, mode=mode, device=d)
            for d in (dev, "cpu"))
    _float_same([torch.from_numpy(a.dist)], [torch.from_numpy(b.dist)], op)
    assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                               b.edges_relaxed)
    a, b = (engine.run(g, src, make_strategy("WD"), op=op, mode="fused",
                       shards=2, device=d) for d in (dev, "cpu"))
    _float_same([torch.from_numpy(a.dist)], [torch.from_numpy(b.dist)], op)
    assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                               b.edges_relaxed)


# ---------------------------------------------------------------------------
# sub-word operators: their own builds of B1, B2, B1's batch contract and
# the fused kernel, against the plain versions on CPU copies
# ---------------------------------------------------------------------------

#: the sub-word operators of the card tests (chip_smoke.subword_ops): SSSP
#: in bfloat16 and int16 (an int32 message the fold narrows), the most
#: reliable path in float16 (a float32 message), BFS levels in int8, the
#: widest path in uint8, path counts in uint8 (add, wrapping), damped
#: counts in bfloat16 (add), and a bfloat16 min whose update admits NaN
SUBWORD_OPS = {
    "bf16_sssp": operators.EdgeOp(
        name="bf16_sssp", combine="min", identity=float("inf"),
        source_value=0.0, message=lambda v, w: v + w, weight_additive=True,
        dtype=torch.bfloat16),
    "f16_reliable": operators.EdgeOp(
        name="f16_reliable", combine="max", identity=0.0, source_value=1.0,
        message=lambda v, w: v * (w / (w + 1.0)), value_min=0,
        dtype=torch.float16),
    "i16_sssp": operators.EdgeOp(
        name="i16_sssp", combine="min", identity=32767, source_value=0,
        message=lambda v, w: v + w, weight_additive=True,
        dtype=torch.int16),
    "i8_levels": operators.EdgeOp(
        name="i8_levels", combine="min", identity=127, source_value=0,
        message=lambda v, w: v + 1, dtype=torch.int8),
    "u8_widest": operators.EdgeOp(
        name="u8_widest", combine="max", identity=0, source_value=255,
        message=lambda v, w: torch.minimum(
            v, w.clamp(0, 255).to(torch.uint8)), value_min=0,
        dtype=torch.uint8),
    "u8_count": operators.EdgeOp(
        name="u8_count", combine="add", identity=0, source_value=1,
        message=lambda v, w: v, dtype=torch.uint8),
    "bf16_damped": operators.EdgeOp(
        name="bf16_damped", combine="add", identity=0.0, source_value=1.0,
        message=lambda v, w: v * 0.5, dtype=torch.bfloat16),
    "bf16_nan_min": operators.EdgeOp(
        name="bf16_nan_min", combine="min", identity=float("inf"),
        source_value=0.0, message=lambda v, w: v - w,
        update=lambda cand, cur: (cand < cur) | (cand != cand),
        dtype=torch.bfloat16),
}
SUBWORD_MINMAX = [name for name, op in SUBWORD_OPS.items()
                  if op.combine != "add" and name != "bf16_nan_min"]


def _subword_values(rng, op, shape):
    """Random values of ``op``'s type and domain (CPU), a tenth of them
    the type's extremes (±0, NaN, ±inf, the largest and least floats; the
    least and largest integers, 0, -1)."""
    if op.dtype.is_floating_point:
        fi = torch.finfo(op.dtype)
        a = rng.random(shape) * (1.0 if op.combine == "max" else 60.0)
        pool = [0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                fi.max, -fi.max, fi.tiny, fi.smallest_normal / 8, -1.0]
        if op.combine == "add":
            pool = [0.0, -0.0, fi.tiny, fi.smallest_normal / 8, 1024.0]
    else:
        ii = torch.iinfo(op.dtype)
        a = rng.integers(0, min(ii.max, 100), shape).astype(np.float64)
        pool = [ii.min, ii.max, 0, -1 if ii.min < 0 else 1]
    if op.combine == "min":
        a[rng.random(shape) < 0.4] = op.identity
    at = rng.random(shape) < 0.1
    a[at] = rng.choice(np.array(pool, np.float64), int(at.sum()))
    t = torch.from_numpy(a)
    return (t.to(op.dtype) if op.dtype.is_floating_point
            else t.to(torch.int64).to(op.dtype))


def _subword_same(got, want, op):
    """Tensors of the card against the CPU's: bools exactly; values of
    min and max, and of an integer add, bit for bit and NaN for NaN; a
    bfloat16 add at rtol 4e-2 (the order of a float sum; 8 bits)."""
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape
        if not a.is_floating_point():
            assert torch.equal(a, b)
            continue
        an, bn = a.isnan(), b.isnan()
        assert torch.equal(an, bn)
        x, y = a[~an], b[~bn]
        if op.combine == "add":
            torch.testing.assert_close(x.float(), y.float(), rtol=4e-2,
                                       atol=0)
        else:
            assert torch.equal(x.view(torch.int16), y.view(torch.int16))


@pytest.mark.parametrize("opname", list(SUBWORD_OPS))
def test_subword_operator_kernels_match_plain(dev, opname):
    """B2 (both contracts), B1 (both) and B1's batch contract built for a
    sub-word operator, against their plain versions on CPU copies: values
    with the type's extremes planted (the folds into dist: the values of
    the operator's domain), int32 weights with int32 extremes; one launch
    each.  The batch's quads are 8 bytes (16-bit values) or 4 (8-bit)."""
    from repro_torch.core import multi_source
    op = SUBWORD_OPS[opname]
    rng = np.random.default_rng(30)
    for n, lanes in ((257, 2050), (5000, 100000)):
        _, src, dst, w, valid = _lanes(rng, operators.shortest_path, n,
                                       lanes, dev)
        dist = _subword_values(rng, op, n).to(dev)
        args = (dist, src, dst, _with_extremes(rng, w), valid)
        before = relax.LAUNCHES["relax_lanes"]
        got = relax.relax_lanes(*args, op=op)
        assert relax.LAUNCHES["relax_lanes"] == before + 1
        _subword_same(got, relax.relax_lanes_plain(
            *(_cpu(a) for a in args), op=op), op)
        mask = _running_mask(rng, n, dev)
        dist = _in_domain(op, dist)
        want = relax.apply_relax_plain(*(_cpu(a) for a in (dist, mask)),
                                       *(_cpu(a) for a in args[1:]), op=op)
        got = relax.apply_relax(dist, mask, *args[1:], op=op)
        assert relax.LAUNCHES["relax_lanes"] == before + 2
        _subword_same(got, want, op)
    g = rmat_graph(scale=10, weighted=True, seed=3, device=dev)
    nodes = np.sort(rng.choice(g.num_nodes, 300, replace=False))
    f = torch.from_numpy(nodes.astype(np.int32)).to(dev)
    deg = g.row_ptr[f + 1] - g.row_ptr[f]
    prefix = torch.cumsum(deg, 0, dtype=torch.int32)
    dist = _subword_values(rng, op, g.num_nodes).to(dev)
    wt = _with_extremes(rng, g.wt)
    args = (dist, prefix, prefix - deg, g.row_ptr[f], f, g.col, wt)
    cpu_args = tuple(_cpu(a) for a in args)
    cap = int(prefix[-1]) + 100
    before = relax.LAUNCHES["wd_relax_lanes"]
    got = relax.wd_relax_lanes(*args, cap_work=cap, op=op)
    assert relax.LAUNCHES["wd_relax_lanes"] == before + 1
    _subword_same(got, relax.wd_relax_lanes_plain(*cpu_args, cap_work=cap,
                                                  op=op), op)
    mask = _running_mask(rng, g.num_nodes, dev)
    dist = _in_domain(op, dist)
    want = relax.wd_apply_relax_plain(dist.cpu(), mask.cpu(), *cpu_args[1:],
                                      cap_work=cap, op=op)
    _subword_same(relax.wd_apply_relax(dist, mask, *args[1:], cap_work=cap,
                                       op=op), want, op)
    for k in (1, 5, 8):
        n = g.num_nodes
        mask_b = torch.from_numpy(rng.random((k, n)) < 0.05).to(dev)
        dist_b = _in_domain(op, _subword_values(rng, op, (k, n)).to(dev))
        dist_t = multi_source.to_node_major(dist_b, op.identity)
        front_t = multi_source.to_node_major(mask_b, False)
        tables = multi_source.union_tables(g, front_t.any(1), n)
        uargs = (dist_t, front_t, *tables, g.col, wt)
        before = relax.LAUNCHES["wd_relax_lanes_batch"]
        got = relax.wd_apply_relax_union(*uargs, cap_work=g.num_edges,
                                         max_lanes=int(tables[0][-1]), op=op)
        assert relax.LAUNCHES["wd_relax_lanes_batch"] == before + 1
        _subword_same(got, relax.wd_apply_relax_union_plain(
            *(_cpu(a) for a in uargs), cap_work=g.num_edges, op=op), op)


@pytest.mark.parametrize("opname", ["u8_count", "i8_levels", "bf16_sssp",
                                    "bf16_nan_min", "u8_widest"])
def test_subword_fold_keeps_its_neighbours(dev, opname):
    """Every lane into the four values of one 32-bit word (or the two of a
    16-bit type's), many lanes each: the compare-and-swap on the enclosing
    word changes only its own value's bytes, whatever the neighbours'
    folds do meanwhile, and the result equals the plain fold."""
    op = SUBWORD_OPS[opname]
    rng = np.random.default_rng(31)
    n, lanes = 64, 4096
    dist = _in_domain(op, _subword_values(rng, op, n)).to(dev)
    src = torch.from_numpy(rng.integers(0, n, lanes).astype(np.int32))
    dst = torch.from_numpy(rng.integers(8, 12, lanes).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 9, lanes).astype(np.int32))
    valid = torch.ones(lanes, dtype=torch.bool)
    args = [a.to(dev) for a in (src, dst, w, valid)]
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    got = relax.apply_relax(dist, mask, *args, op=op)
    want = relax.apply_relax_plain(dist.cpu(), mask.cpu(), src, dst, w,
                                   valid, op=op)
    _subword_same(got, want, op)
    outside = torch.ones(n, dtype=torch.bool)
    outside[8:12] = False
    _subword_same([got[0].cpu()[outside]], [dist.cpu()[outside]], op)


def _subword_graph(opname, dev):
    """rmat12 from its highest-degree node; the add operators on the
    layered DAG from node 0."""
    if SUBWORD_OPS[opname].combine == "add":
        return _layered_dag(dev), 0
    g = rmat_graph(scale=12, weighted=True, seed=1, device=dev)
    return g, int(g.degrees.argmax())


@pytest.mark.parametrize("opname", ["bf16_sssp", "f16_reliable", "i16_sssp",
                                    "i8_levels", "u8_widest", "u8_count",
                                    "bf16_damped"])
@pytest.mark.parametrize("run", list(FUSED_RUNS))
def test_subword_fused_kernel_matches_plain(dev, run, opname):
    """Every strategy: the sub-word fused kernel's (dist, iterations,
    edges, AD's choices, chunks) equal the plain loop's on CPU copies, in
    one fused launch and no B1/B2 launch."""
    strategy, kwargs = FUSED_RUNS[run]
    op = SUBWORD_OPS[opname]
    g, source = _subword_graph(opname, dev)
    got, want, launched = _fused_float_pair(g, strategy, kwargs, op, source)
    _subword_same([got[0]], [want[0]], op)
    assert got[1:] == want[1:]
    assert launched["fused_fixed_point"] == 1
    assert launched["relax_lanes"] == launched["wd_relax_lanes"] == 0


@pytest.mark.parametrize("delta", [4, 25])
@pytest.mark.parametrize("opname", ["bf16_sssp", "i16_sssp", "u8_widest",
                                    "f16_reliable"])
@pytest.mark.parametrize("strategy", ["BS", "WD", "NS", "HP", "AD"])
def test_subword_fused_delta_kernel_matches_plain(dev, strategy, opname,
                                                  delta):
    """Road side 128: the sub-word delta mode's (dist, mask, epochs,
    rounds, edges, last bucket, frontier count, rounds by kind) equal the
    plain epoch loop's on CPU copies, whole and capped at one epoch, in
    one launch: the buckets in the value type, as worklist.bucket_index
    has them (int16's all -1, uint8's reflected in uint8, float16's
    reflections of inf in bucket 0)."""
    from repro_torch.core import priority
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import road_grid_graph
    from repro_torch.kernels import fused as kernel_fused
    op = SUBWORD_OPS[opname]
    g = road_grid_graph(side=128, weighted=True, seed=4, device=dev)
    source = 128 * 64 + 17
    strat = make_strategy(strategy)
    plan = priority.plan_delta(strat, strat.setup(g), g, op=op, delta=delta)
    n = plan.light.num_nodes
    dist = torch.full((n,), op.identity, dtype=op.dtype, device=dev)
    dist[source] = op.seed(source)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[source] = True
    for cap in (100000, 1):
        kw = dict(op=op, sched=plan.sched, delta=plan.delta,
                  max_iterations=cap)
        before = relax.LAUNCHES["fused_fixed_point"]
        got = kernel_fused.delta_fixed_point(
            plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist, mask,
            **kw)
        assert relax.LAUNCHES["fused_fixed_point"] == before + 1
        heavy = plan.heavy_graph
        want = priority._delta_fixed_point_plain(
            plan.kernel, plan.light.to("cpu"),
            None if heavy is None else heavy.to("cpu"), _cpu(plan.aux),
            dist.cpu(), mask.cpu(), **kw)
        _subword_same(got[:2], want[:2], op)
        assert got[2:] == want[2:]


@pytest.mark.parametrize("run", ["WD", "BS", "EP", "NS", "AD"])
@pytest.mark.parametrize("opname", ["bf16_sssp", "i16_sssp", "i8_levels",
                                    "u8_widest", "u8_count"])
def test_subword_engine_on_the_card_matches_cpu(dev, monkeypatch, opname,
                                                run):
    """``engine.run`` with a sub-word operator, stepped and fused, on the
    card equals the CPU's run, and the card run reaches no plain relax:
    only the operator's own kernels launch."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    strategy, kwargs = ENGINE_RUNS[run]
    op = SUBWORD_OPS[opname]
    g, src = _subword_graph(opname, "cpu")
    for mode in ("stepped", "fused"):
        b = engine.run(g, src, make_strategy(strategy, **kwargs), op=op,
                       mode=mode, device="cpu")
        with monkeypatch.context() as m:
            _no_plain_relax(m)
            a = engine.run(g, src, make_strategy(strategy, **kwargs), op=op,
                           mode=mode, device=dev)
        assert a.dist.dtype == b.dist.dtype
        np.testing.assert_array_equal(a.dist, b.dist)
        assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                                   b.edges_relaxed)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("opname", SUBWORD_MINMAX)
def test_subword_batch_and_shards_on_the_card_match_cpu(dev, opname, mode):
    """A K = 8 batch (B1's union contract stepped, a fused launch a row
    fused), its rows against single runs, and a two-shard lockstep WD run
    with a sub-word operator: the card equals the CPU."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    op = SUBWORD_OPS[opname]
    g, src = _subword_graph(opname, "cpu")
    sources = [src, 0, 3, 3, 100, 7, 2048, 4095]
    a, b = (engine.run_batch(g, sources, op=op, mode=mode, device=d)
            for d in (dev, "cpu"))
    np.testing.assert_array_equal(a.dist, b.dist)
    assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                               b.edges_relaxed)
    for row, s in zip(a.dist, sources):
        np.testing.assert_array_equal(row, engine.run(
            g, s, make_strategy("WD"), op=op, mode="fused",
            device=dev).dist)
    a, b = (engine.run(g, src, make_strategy("WD"), op=op, mode="fused",
                       shards=2, device=d) for d in (dev, "cpu"))
    np.testing.assert_array_equal(a.dist, b.dist)
    assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                               b.edges_relaxed)


def test_subword_union_refuses_a_misaligned_quad(dev):
    """The batch contract loads a node's four values of a 16-bit type as
    one 8-byte quad: a node-major view off that alignment raises."""
    from repro_torch.core import multi_source
    op = SUBWORD_OPS["i16_sssp"]
    g = rmat_graph(scale=8, weighted=True, seed=3, device=dev)
    n = g.num_nodes
    dist_t = torch.full((n * 4 + 1,), 7, dtype=torch.int16,
                        device=dev)[1:].view(n, 4)
    front_t = torch.zeros((n, 4), dtype=torch.bool, device=dev)
    front_t[0] = True
    tables = multi_source.union_tables(g, front_t.any(1), n)
    with pytest.raises(ValueError, match="boundary"):
        relax.wd_apply_relax_union(dist_t, front_t, *tables, g.col, g.wt,
                                   cap_work=g.num_edges,
                                   max_lanes=int(tables[0][-1]), op=op)
