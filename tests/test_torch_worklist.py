"""The port's worklist helpers and MDT heuristic against the JAX
reference, on the CPU (exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import node_split as jnode_split
from repro.core import worklist as jworklist
from repro_torch.core import node_split, worklist


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 5000])
def test_bucket(n):
    assert worklist.bucket(n) == jworklist.bucket(n)
    assert worklist.bucket(n, 64) == jworklist.bucket(n, 64)


@pytest.mark.parametrize("cap", [8, 64, 256])
def test_compact_mask_pads_and_truncates_like_the_reference(cap):
    mask = np.random.default_rng(cap).random(100) < 0.3
    got = worklist.compact_mask(torch.from_numpy(mask), cap)
    want = jworklist.compact_mask(jnp.asarray(mask), cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert worklist.mask_count(torch.from_numpy(mask)) == int(mask.sum())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("slack", [0, -3])
def test_run_fill_matches_reference(seed, slack):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 6, 40).astype(np.int32)
    starts = rng.integers(0, 1000, 40).astype(np.int32)
    total = int(lengths.sum()) + slack
    cap = worklist.bucket(int(lengths.sum()), 16)
    got = worklist.run_fill(torch.from_numpy(starts),
                            torch.from_numpy(lengths), total, cap)
    want = jworklist.run_fill(jnp.asarray(starts), jnp.asarray(lengths),
                              jnp.asarray(total), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("bins", [4, 10])
def test_find_mdt_matches_reference(seed, bins):
    deg = np.random.default_rng(seed).zipf(1.8, 3000).clip(0, 5000)
    deg[::7] = 0
    assert node_split.find_mdt(deg, bins) == jnode_split.find_mdt(deg, bins)
    assert node_split.find_mdt(np.zeros(5, int)) == 1
