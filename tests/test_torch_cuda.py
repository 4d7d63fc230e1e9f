"""The port's CUDA kernels on the card: each against its plain PyTorch
version (exact), the wrappers' argument checks, and the stepped engine on
the card against the CPU.  Every test here needs a CUDA device and skips
without one.  The file imports neither JAX nor ``repro``, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.algos import bfs, sssp
from repro_torch.core import operators
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


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("n,lanes", [(3, 2), (257, 2050), (5000, 100000)])
def test_relax_lanes_kernel_matches_plain(dev, opname, n, lanes):
    op = operators.OPERATORS[opname]
    args = _lanes(np.random.default_rng(n + lanes), op, n, lanes, dev)
    before = relax.LAUNCHES["relax_lanes"]
    got = relax.relax_lanes(*args, op=op)
    assert relax.LAUNCHES["relax_lanes"] == before + 1
    _same(got, relax.relax_lanes_plain(*args, op=op))


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


def test_custom_operator_on_cuda_raises(dev):
    op = operators.EdgeOp(name="slack", combine="min",
                          identity=operators.INF, source_value=0,
                          message=lambda v, w: v + w,
                          update=lambda cand, cur: cand + 2 < cur)
    args = _lanes(np.random.default_rng(1), op, 50, 80, dev)
    with pytest.raises(NotImplementedError, match="queue C"):
        relax.relax_lanes(*args, op=op)


@pytest.mark.parametrize("strategy", ["WD", "BS", "HP", "AD"])
def test_engine_on_the_card_matches_cpu(dev, strategy):
    g = rmat_graph(scale=12, weighted=True, seed=1, device="cpu")
    src = int(g.degrees.argmax())
    for fn in (sssp, bfs):
        a = fn(g, src, strategy=strategy, device=dev)
        b = fn(g, src, strategy=strategy, device="cpu")
        assert a.device == "cuda" and b.device == "cpu"
        np.testing.assert_array_equal(a.dist, b.dist)
        assert (a.iterations, a.edges_relaxed) == (b.iterations,
                                                   b.edges_relaxed)
