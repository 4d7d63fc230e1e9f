"""Synthetic graph generators — the reference's numpy generators (GTgraph
RMAT / Erdős–Rényi, Graph500 Kronecker, USA-road-like grids), drawing
the same ``np.random.default_rng`` streams so every graph is bit-identical
to :mod:`repro.data.graphs` for the same arguments.  Graphs are built on
the host and moved to ``device`` once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.graph import CSRGraph


def _finish(src, dst, num_nodes, weighted, seed, device,
            dedup=True) -> CSRGraph:
    keep = src != dst                      # drop self-loops
    src, dst = src[keep], dst[keep]
    wt = None
    if weighted:
        rng = np.random.default_rng(seed + 0x9E3779B9)
        wt = rng.integers(1, 101, size=len(src)).astype(np.int32)
    return CSRGraph.from_edges(src, dst, wt, num_nodes, dedup=dedup,
                               device=device)


def _rmat_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
                seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Recursive-matrix edge generation (Chakrabarti et al.), vectorized."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab) if ab < 1.0 else 0.0
    a_norm = a / ab if ab > 0 else 0.0
    for bit in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = (r1 > ab).astype(np.int64)
        dst_bit = ((r1 > ab) & (r2 > c_norm)
                   | (r1 <= ab) & (r2 > a_norm)).astype(np.int64)
        src |= src_bit << bit
        dst |= dst_bit << bit
    # permute vertex labels so degree doesn't correlate with id
    perm = rng.permutation(n)
    return perm[src], perm[dst]


def rmat_graph(scale: int = 14, edge_factor: int = 8, *,
               weighted: bool = False, seed: int = 1,
               device="cuda") -> CSRGraph:
    """RMAT graph (paper: rmat20, edge_factor 8, skewed power-law)."""
    src, dst = _rmat_edges(scale, edge_factor, 0.45, 0.22, 0.22, seed)
    return _finish(src, dst, 1 << scale, weighted, seed, device)


def graph500_graph(scale: int = 16, edge_factor: int = 16, *,
                   weighted: bool = False, seed: int = 2,
                   device="cuda") -> CSRGraph:
    """Graph500 Kronecker parameters (A=.57,B=.19,C=.19) — the paper's
    'large graph' family with extreme degree skew."""
    src, dst = _rmat_edges(scale, edge_factor, 0.57, 0.19, 0.19, seed)
    return _finish(src, dst, 1 << scale, weighted, seed, device)


def erdos_renyi_graph(scale: int = 14, edge_factor: int = 4, *,
                      weighted: bool = False, seed: int = 3,
                      device="cuda") -> CSRGraph:
    """Erdős–Rényi G(n, m): uniform random edges (paper's ER20/ER23)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return _finish(src, dst, n, weighted, seed, device)


def road_grid_graph(side: int = 128, *, weighted: bool = False,
                    seed: int = 4, diag_frac: float = 0.05,
                    device="cuda") -> CSRGraph:
    """Road-network stand-in: 2-D grid (large diameter, max degree ≤ 8,
    tiny variance) with a few diagonal shortcuts."""
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    ids = (ii * side + jj).ravel()
    edges = []
    for di, dj in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        ni, nj = ii + di, jj + dj
        ok = (ni >= 0) & (ni < side) & (nj >= 0) & (nj < side)
        edges.append((ids[ok.ravel()], (ni * side + nj).ravel()[ok.ravel()]))
    rng = np.random.default_rng(seed)
    k = int(n * diag_frac)
    extra_s = rng.integers(0, n, size=k)
    extra_d = np.clip(extra_s + rng.integers(1, side, size=k), 0, n - 1)
    edges.append((extra_s, extra_d))
    edges.append((extra_d, extra_s))
    src = np.concatenate([e[0] for e in edges])
    dst = np.concatenate([e[1] for e in edges])
    return _finish(src, dst, n, weighted, seed, device)


# Benchmark suite mirroring the paper's Table II, scaled down; the same
# specs as repro.data.graphs.GRAPH_SUITE.
GRAPH_SUITE = {
    # paper: rmat20 (1.05M nodes, 8.26M edges, maxdeg 1181)
    "rmat": dict(kind="rmat", scale=14, edge_factor=8),
    # paper: road-FLA/W/USA (maxdeg 9, avg 3)
    "road": dict(kind="road", side=160),
    # paper: ER20/ER23 (maxdeg 10-15, avg 3-4)
    "er": dict(kind="er", scale=14, edge_factor=4),
    # paper: Graph500 (16.78M nodes, 335M edges, maxdeg 924k) — 3 seeds
    "graph500_a": dict(kind="graph500", scale=15, edge_factor=16, seed=11),
    "graph500_b": dict(kind="graph500", scale=15, edge_factor=16, seed=12),
    "graph500_c": dict(kind="graph500", scale=15, edge_factor=16, seed=13),
}

_MAKERS = {"rmat": rmat_graph, "graph500": graph500_graph,
           "er": erdos_renyi_graph, "road": road_grid_graph}


def make_graph(name: str, *, weighted: bool = False,
               scale_override: Optional[int] = None,
               device="cuda") -> CSRGraph:
    spec = dict(GRAPH_SUITE[name])
    kind = spec.pop("kind")
    if scale_override is not None and "scale" in spec:
        spec["scale"] = scale_override
    if kind not in _MAKERS:
        raise ValueError(f"unknown graph kind {kind!r}")
    return _MAKERS[kind](weighted=weighted, device=device, **spec)
