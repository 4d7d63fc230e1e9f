"""B1's batch contract on the union frontier, node-major, on the CPU, where
``relax.wd_apply_relax_union`` runs its plain version: the port's
``multi_source.batched_wd_relax`` against the reference's (``backend="xla"``)
and against the row-by-row oracle ``relax.wd_apply_relax_batch_plain``, bit
for bit, for the four built-in operators and K of 1, 3, 5 and 8, with
overlapping, disjoint, empty and duplicate rows, and rows cut by ``cap``
and by ``cap_work``; the node-major layout and the union's slot tables;
what the wrapper issues on the card (one copy, one zeroed frontier, one
launch) and the arguments it refuses; one relax a stepped iteration."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multi_source as jms
from repro.core import operators as joperators
from repro.data import graphs as jgraphs
from repro_torch.core import engine, multi_source, operators
from repro_torch.core.graph import CSRGraph
from repro_torch.kernels import relax

OP_NAMES = ("shortest_path", "min_label", "widest_path", "reach_count")

JAX_G = jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True, seed=1)
G = CSRGraph.from_arrays(np.asarray(JAX_G.row_ptr), np.asarray(JAX_G.col),
                         np.asarray(JAX_G.wt), device="cpu")
N = G.num_nodes


def _rows(rng, k: int) -> np.ndarray:
    """``[k, N]`` frontiers: rows overlapping a shared core, a row
    disjoint from it, an empty row and a duplicate of row 0 (as far as
    ``k`` goes), the rest random of varied density."""
    core = rng.random(N) < 0.15
    mask = np.zeros((k, N), bool)
    for r in range(k):
        kind = r % 5
        if kind == 0:
            mask[r] = core | (rng.random(N) < 0.02)
        elif kind == 1:
            mask[r] = ~core & (rng.random(N) < 0.2)
        elif kind == 2:
            mask[r] = False
        elif kind == 3:
            mask[r] = mask[0]
        else:
            mask[r] = rng.random(N) < rng.uniform(0.001, 0.4)
    return mask


def _values(rng, op, k: int) -> np.ndarray:
    if op.combine == "add":
        return rng.integers(0, 4, (k, N)).astype(np.int32)
    dist = rng.integers(0, 300, (k, N)).astype(np.int32)
    if op.combine == "min":
        dist[rng.random((k, N)) < 0.3] = op.identity
    return dist


def _caps(mask: np.ndarray) -> tuple:
    """``(cap, cap_work)`` as ``run_batch`` takes them: every row whole."""
    deg = np.asarray(JAX_G.degrees)
    return (max(int(mask.sum(1).max()), 1),
            max(int((mask * deg).sum(1).max()), 1))


def _check(dist, mask, op, cap, cap_work):
    """The port against the reference and against the row-by-row
    oracle; returns the port's ``(dist, next frontier)``."""
    want = jms.batched_wd_relax(JAX_G, jnp.asarray(dist), jnp.asarray(mask),
                                cap=cap, cap_work=cap_work,
                                op=joperators.resolve(op.name),
                                backend="xla")
    d, m = torch.from_numpy(dist), torch.from_numpy(mask)
    got = multi_source.batched_wd_relax(G, d, m, cap=cap, cap_work=cap_work,
                                        op=op)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    tables = multi_source.row_tables(G, m, cap)
    rows = relax.wd_apply_relax_batch_plain(
        d, torch.zeros_like(m), *tables, G.col, G.wt, cap_work=cap_work,
        op=op)
    assert torch.equal(got[0], rows[0]) and torch.equal(got[1], rows[1])
    return got


@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("opname", OP_NAMES)
def test_union_matches_reference_and_rows(opname, k):
    """Whole rows (run_batch's capacities) and rows cut at half the widest
    frontier and a third of the largest total."""
    op = operators.OPERATORS[opname]
    rng = np.random.default_rng(100 * k + OP_NAMES.index(opname))
    mask = _rows(rng, k)
    dist = _values(rng, op, k)
    if k >= 4:                                  # a duplicate source
        dist[3] = dist[0]
    cap, cap_work = _caps(mask)
    got = _check(dist, mask, op, cap, cap_work)
    assert got[1].any()
    if k >= 3:                                  # the empty row
        assert not got[1][2].any() and np.array_equal(got[0][2].numpy(),
                                                      dist[2])
    if k >= 4:                                  # the duplicate row
        assert torch.equal(got[0][3], got[0][0])
    _check(dist, mask, op, max(cap // 2, 1), max(cap_work // 3, 1))


@pytest.mark.parametrize("cut", ["cap", "cap_work", "both", "one lane"])
def test_union_rows_cut(cut):
    """A ``cap`` below the widest row's frontier, a ``cap_work`` inside
    one row's edges (off any tile), both, and one lane a row."""
    op = operators.shortest_path
    rng = np.random.default_rng(41)
    mask = _rows(rng, 5)
    dist = _values(rng, op, 5)
    cap, cap_work = _caps(mask)
    cap, cap_work = {"cap": (cap - 7, cap_work),
                     "cap_work": (cap, cap_work - 333),
                     "both": (cap // 3, cap_work // 2 + 1),
                     "one lane": (cap, 1)}[cut]
    _check(dist, mask, op, cap, cap_work)


def test_node_major_layout():
    """``[K, N]`` -> ``[N, Kp]`` and back, the padded columns filled."""
    rng = np.random.default_rng(2)
    for k in range(10):
        x = torch.from_numpy(rng.integers(0, 9, (k, 13)).astype(np.int32))
        t = multi_source.to_node_major(x, -5)
        kp = multi_source.row_quads(k)
        assert kp % 4 == 0 and k <= kp < k + 4
        assert t.shape == (13, kp) and t.is_contiguous()
        assert (t[:, k:] == -5).all()
        assert torch.equal(multi_source.from_node_major(t, k), x)


def test_union_tables_match_numpy():
    """The union's slot tables: its nodes ascending, each with its whole
    degree, then zero-degree padding."""
    rng = np.random.default_rng(3)
    live = rng.random(N) < 0.1
    slots = int(live.sum()) + 5
    prefix, excl, start, src = multi_source.union_tables(
        G, torch.from_numpy(live), slots)
    nodes = np.flatnonzero(live)
    row_ptr = np.asarray(JAX_G.row_ptr)
    deg = np.concatenate([np.diff(row_ptr)[nodes], np.zeros(5, np.int64)])
    np.testing.assert_array_equal(src.numpy(),
                                  np.concatenate([nodes, np.zeros(5)]))
    np.testing.assert_array_equal(prefix.numpy(), np.cumsum(deg))
    np.testing.assert_array_equal(excl.numpy(), np.cumsum(deg) - deg)
    np.testing.assert_array_equal(
        start.numpy(), row_ptr[np.concatenate([nodes, np.zeros(5, int)])])


class _AtenLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the ATen operators that run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _union_args(k: int):
    rng = np.random.default_rng(k)
    mask = torch.from_numpy(_rows(rng, k))
    dist_t = multi_source.to_node_major(
        torch.from_numpy(_values(rng, operators.shortest_path, k)),
        operators.shortest_path.identity)
    front_t = multi_source.to_node_major(mask, False)
    tables = multi_source.union_tables(G, front_t.any(1), N)
    return dist_t, front_t, tables


def _as_if_on_the_card(monkeypatch):
    """Take the wrapper's CUDA branch with CPU tensors and a fake launch
    that records its kernel and arguments."""
    launched = []
    for counts in ("LAUNCHES", "LANES"):
        monkeypatch.setattr(relax, counts, dict(getattr(relax, counts)))
    monkeypatch.setattr(relax, "_dispatch", lambda dist, name: True)
    monkeypatch.setattr(relax._build, "op_library",
                        lambda op: (None, *op.kernel_codes()[:2]))
    monkeypatch.setattr(relax, "_launch",
                        lambda name, dev, library, *args: launched.append(
                            (name, args)))
    return launched


def test_union_on_the_card_is_one_copy_and_one_launch(monkeypatch):
    """On a CUDA tensor the contract issues one copy of ``dist_t`` (the
    target), one zeroed frontier and one launch, counted once, its lanes
    the bound times the row quads; no row table is passed unless given."""
    launched = _as_if_on_the_card(monkeypatch)
    dist_t, front_t, tables = _union_args(6)
    with _AtenLog() as log:
        out, upd = relax.wd_apply_relax_union(
            dist_t, front_t, *tables, G.col, G.wt, cap_work=50,
            max_lanes=1234)
    assert [name for name, _ in launched] == ["wd_relax_union"]
    args = launched[0][1]
    assert args[1:3] == (N, 8) and args[9] is None and args[10] == 50
    assert args[14] == 1234
    assert relax.LAUNCHES["wd_relax_lanes_batch"] == 1
    assert relax.LANES["wd_relax_lanes_batch"] == 1234 * 2
    assert out.data_ptr() != dist_t.data_ptr() and upd.shape == (N, 8)
    assert sorted(log.ops) in (["clone", "zeros_like"],
                               ["clone", "empty_like", "zero_"])
    mine = torch.zeros((N, 8), dtype=torch.int32)
    relax.wd_apply_relax_union(dist_t, front_t, *tables, G.col, None,
                               cap_work=50, max_lanes=0, row_excl=mine)
    assert launched[1][1][9] == mine.data_ptr()
    assert launched[1][1][12] is None                 # no weights
    assert relax.LAUNCHES["wd_relax_lanes_batch"] == 2


def test_union_wrapper_rejects_bad_arguments(monkeypatch):
    """Columns not in fours, a frontier of another shape or type, slot
    tables of different lengths, a row table of the wrong shape, and a
    ``cap_work`` outside int32."""
    _as_if_on_the_card(monkeypatch)
    dist_t, front_t, tables = _union_args(5)
    kw = dict(cap_work=10, max_lanes=10)
    with pytest.raises(ValueError, match="fours"):
        relax.wd_apply_relax_union(dist_t[:, :6].contiguous(),
                                   front_t[:, :6].contiguous(), *tables,
                                   G.col, G.wt, **kw)
    with pytest.raises(ValueError):
        relax.wd_apply_relax_union(dist_t, front_t[:, :4].contiguous(),
                                   *tables, G.col, G.wt, **kw)
    with pytest.raises(TypeError):
        relax.wd_apply_relax_union(dist_t, front_t.int(), *tables, G.col,
                                   G.wt, **kw)
    with pytest.raises(ValueError):
        relax.wd_apply_relax_union(dist_t, front_t, tables[0][:-1],
                                   *tables[1:], G.col, G.wt, **kw)
    with pytest.raises(ValueError):
        relax.wd_apply_relax_union(dist_t, front_t, *tables, G.col, G.wt,
                                   row_excl=torch.zeros((N, 4),
                                                        dtype=torch.int32),
                                   **kw)
    with pytest.raises(ValueError, match="cap_work"):
        relax.wd_apply_relax_union(dist_t, front_t, *tables, G.col, G.wt,
                                   cap_work=2 ** 31, max_lanes=1)


@pytest.mark.parametrize("opname", ["shortest_path", "widest_path"])
def test_stepped_batch_is_one_union_relax_an_iteration(monkeypatch, opname):
    """A stepped ``run_batch`` relaxes through the union contract once an
    iteration, with no row table (its capacities cut no row) and the
    union's exact edges as the grid's bound."""
    calls = []
    real = relax.wd_apply_relax_union

    def counting(dist_t, front_t, prefix, *args, **kw):
        calls.append((kw["row_excl"], kw["max_lanes"], int(prefix[-1])))
        return real(dist_t, front_t, prefix, *args, **kw)

    monkeypatch.setattr(relax, "wd_apply_relax_union", counting)
    deg = np.asarray(JAX_G.degrees)
    sources = [int(deg.argmax()), 3, 17, int(deg.argmax()), 42]
    r = engine.run_batch(G, sources, op=opname, device="cpu")
    assert len(calls) == r.iterations > 1
    assert all(rx is None and bound == total for rx, bound, total in calls)
