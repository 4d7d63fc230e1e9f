"""Graph construction of the port against the JAX reference, on the CPU:
every GRAPH_SUITE family, weighted and not, must be bit-identical."""

import numpy as np
import pytest
import torch

from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.core.graph import graph_stats as jax_graph_stats
from repro.data import graphs as jgraphs
from repro_torch.core.graph import CSRGraph, graph_stats, resolve_device
from repro_torch.data import graphs as tgraphs


def _build(mod, name, weighted, device=None):
    kw = {} if device is None else {"device": device}
    if name == "road":      # the suite's road is side 160; keep it small
        return mod.road_grid_graph(side=14, weighted=weighted, **kw)
    return mod.make_graph(name, weighted=weighted, scale_override=8, **kw)


def _assert_same(tg: CSRGraph, jg: JaxCSRGraph):
    np.testing.assert_array_equal(tg.row_ptr.numpy(), np.asarray(jg.row_ptr))
    np.testing.assert_array_equal(tg.col.numpy(), np.asarray(jg.col))
    if jg.wt is None:
        assert tg.wt is None
    else:
        np.testing.assert_array_equal(tg.wt.numpy(), np.asarray(jg.wt))
    assert (tg.num_nodes, tg.num_edges, tg.max_degree) == (
        jg.num_nodes, jg.num_edges, jg.max_degree)
    for t in (tg.row_ptr, tg.col) + (() if tg.wt is None else (tg.wt,)):
        assert t.dtype == torch.int32 and t.device.type == "cpu"


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("name", list(jgraphs.GRAPH_SUITE))
def test_suite_graph_bit_identical(name, weighted):
    jg = _build(jgraphs, name, weighted)
    tg = _build(tgraphs, name, weighted, device="cpu")
    _assert_same(tg, jg)
    assert graph_stats(tg) == jax_graph_stats(jg)
    assert tg.device_bytes() == jg.device_bytes()


@pytest.mark.parametrize("weighted", [True, False])
def test_from_arrays_round_trips_a_reference_graph(weighted):
    jg = jgraphs.rmat_graph(scale=9, weighted=weighted, seed=4)
    tg = CSRGraph.from_arrays(np.asarray(jg.row_ptr), np.asarray(jg.col),
                              None if jg.wt is None else np.asarray(jg.wt),
                              device="cpu")
    _assert_same(tg, jg)
    np.testing.assert_array_equal(tg.degrees.numpy(), np.asarray(jg.degrees))
    assert tg.to("cpu") is tg
    assert tg.unweighted().wt is None


def test_from_edges_matches_with_dedup_and_isolated_nodes():
    rng = np.random.default_rng(7)
    src = rng.integers(0, 40, 300)
    dst = rng.integers(0, 40, 300)
    wt = rng.integers(1, 9, 300)
    jg = JaxCSRGraph.from_edges(src, dst, wt, 50, dedup=True)
    tg = CSRGraph.from_edges(src, dst, wt, 50, dedup=True, device="cpu")
    _assert_same(tg, jg)


def test_from_arrays_rejects_malformed_csr():
    with pytest.raises(ValueError):
        CSRGraph.from_arrays(np.array([0, 2, 1]), np.array([1, 0]),
                             device="cpu")
    with pytest.raises(ValueError):
        CSRGraph.from_arrays(np.array([0, 1]), np.array([1, 0]),
                             device="cpu")
    with pytest.raises(ValueError):
        CSRGraph.from_arrays(np.array([0, 1]), np.array([0]),
                             np.array([1, 2]), device="cpu")


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgraphs.rmat_graph(scale=5)
