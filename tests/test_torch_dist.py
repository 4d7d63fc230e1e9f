"""The port's distributed SSSP (``repro_torch.core.dist``, ROADMAP A11)
on the CPU: ``partition_graph`` equals the reference's array for array
(it uses only numpy and ``jnp.asarray``, so it runs here), and
``distributed_sssp`` (a WD merge path a shard, B3's plain version for the
lane search, the bucketed exchange by ``ShardGroup.all_to_all``) equals
Dijkstra and the reference's single-device run, with every shard in one
process and with two gloo ranks, one shard each."""

import numpy as np
import pytest

from repro.core import dist as jdist
from repro.core import engine as jengine
from repro.data import graphs as jgraphs
from repro_torch.core import dist, shard
from repro_torch.core.engine import reference_distances
from repro_torch.kernels import find_offsets
from test_torch_shard import JAX_GRAPHS, _port, spawn_ranks

GRAPHS = {
    "rmat": JAX_GRAPHS["rmat"],
    "road": JAX_GRAPHS["road"],
    "er": jgraphs.erdos_renyi_graph(scale=7, edge_factor=4, weighted=False,
                                    seed=3),
}


@pytest.mark.parametrize("parts", [1, 2, 3, 5])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_partition_graph_matches_reference(gname, parts):
    got = dist.partition_graph(_port(GRAPHS[gname]), parts)
    want = jdist.partition_graph(GRAPHS[gname], parts)
    for field in ("row_ptr", "col", "wt"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for field in ("num_nodes", "n_loc", "e_loc", "num_parts"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_distributed_sssp_matches_dijkstra(gname, parts):
    jg, g = GRAPHS[gname], _port(GRAPHS[gname])
    src = int(np.argmax(np.asarray(jg.degrees)))
    got = dist.distributed_sssp(g, src, shard.shard_group(parts, "cpu"))
    np.testing.assert_array_equal(got, reference_distances(g, src))
    want = jengine.run(jg, src, jengine.make_strategy("WD"), mode="fused")
    np.testing.assert_array_equal(got, np.asarray(want.dist))


def test_distributed_sssp_searches_with_b3(monkeypatch):
    """Every iteration's lane search is ``kernels.find_offsets`` (its plain
    version here), once a shard."""
    assert dist.find_offsets is find_offsets.find_offsets
    calls = []

    def spy(prefix, cap_work):
        calls.append(cap_work)
        return find_offsets.find_offsets(prefix, cap_work)
    monkeypatch.setattr(dist, "find_offsets", spy)
    dist.distributed_sssp(_port(GRAPHS["road"]), 0,
                          shard.shard_group(3, "cpu"), max_iterations=4)
    assert len(calls) == 4 * 3


def test_two_gloo_ranks_match_one_process(tmp_path):
    jg, g = GRAPHS["rmat"], _port(GRAPHS["rmat"])
    src = int(np.argmax(np.asarray(jg.degrees)))
    one = dist.distributed_sssp(g, src, shard.shard_group(2, "cpu"))
    for out in spawn_ranks(tmp_path, "dist", "rmat", src):
        np.testing.assert_array_equal(out["dist"], one)
