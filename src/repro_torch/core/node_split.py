"""Node splitting (paper §III-B): graph preprocessing that bounds the
maximum outdegree by MDT, plus the histogram heuristic that picks MDT.

As in the reference, this is morph work done once, host-side in numpy;
the split graph then moves to the input graph's device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph


def find_mdt(degrees: np.ndarray, histogram_bins: int = 10) -> int:
    """Histogram-based automatic MDT (paper §III-B).

    Bin the outdegrees into ``histogram_bins`` ranges over [0, maxDegree],
    take the tallest bin and set
    ``MDT = (upper edge of that bin / bins) × maxDegree``."""
    degrees = np.asarray(degrees)
    degrees = degrees[degrees > 0]
    if degrees.size == 0:
        return 1
    max_degree = int(degrees.max())
    if max_degree <= 1:
        return 1
    hist, _ = np.histogram(degrees, bins=histogram_bins,
                           range=(0, max_degree))
    bin_index = int(np.argmax(hist))
    mdt = int(round((bin_index + 1) / histogram_bins * max_degree))
    return max(1, mdt)


@dataclasses.dataclass
class SplitGraph:
    """The split graph + parent bookkeeping.

    Node ids 0..N-1 are the originals (each keeps its first ≤MDT edges);
    children occupy N..N2-1 and carry the remaining edge slices.  Edges
    still target parents only (dst ids are unchanged), so
    ``child_parent`` lets each iteration mirror parent values onto
    children (``strategies.ns_activate``)."""

    graph: CSRGraph
    child_parent: torch.Tensor   # [N2] int32; originals map to themselves
    num_original: int
    mdt: int
    num_children: int

    def extract_original(self, dist: torch.Tensor) -> torch.Tensor:
        return dist[: self.num_original]


def split_graph(g: CSRGraph, mdt: int) -> SplitGraph:
    """Split every node with outdegree > MDT into ⌈deg/MDT⌉ pieces, edges
    partitioned contiguously among parent + children (paper Fig. 5).
    Built in numpy from ``g``'s arrays; the result lies on ``g``'s
    device."""
    mdt = max(1, int(mdt))
    row_ptr = g.row_ptr.cpu().numpy().astype(np.int64)
    col = g.col.cpu().numpy()
    wt = None if g.wt is None else g.wt.cpu().numpy()
    n = g.num_nodes
    deg = row_ptr[1:] - row_ptr[:-1]

    pieces = np.maximum(1, -(-deg // mdt))          # ⌈deg/MDT⌉, ≥1
    n_children = int((pieces - 1).sum())
    n2 = n + n_children

    # new-node table: originals first, then children grouped by parent
    parent_of = np.arange(n2, dtype=np.int64)
    piece_idx = np.zeros(n2, dtype=np.int64)        # which slice of parent
    child_rows = np.repeat(np.arange(n), pieces - 1)
    parent_of[n:] = child_rows
    if n_children:
        # per-parent running piece index 1..pieces-1
        first_child = np.zeros(n, np.int64)
        np.cumsum(pieces - 1, out=first_child)
        first_child = np.concatenate([[0], first_child[:-1]]) + n
        piece_idx[n:] = (np.arange(n_children) - (first_child[child_rows] - n)
                         + 1)

    # per-new-node edge slice [start, start+len) of the parent's adjacency
    starts = row_ptr[parent_of] + piece_idx * mdt
    lens = np.maximum(np.minimum(deg[parent_of] - piece_idx * mdt, mdt), 0)

    new_row_ptr = np.zeros(n2 + 1, np.int64)
    np.cumsum(lens, out=new_row_ptr[1:])
    total = int(new_row_ptr[-1])
    if total != g.num_edges:
        raise AssertionError(f"split graph holds {total} edges, not "
                             f"{g.num_edges}")
    gather = (np.repeat(starts, lens) + np.arange(total)
              - np.repeat(new_row_ptr[:-1], lens))
    g2 = CSRGraph.from_arrays(new_row_ptr, col[gather],
                              None if wt is None else wt[gather],
                              device=g.device)
    return SplitGraph(
        graph=g2,
        child_parent=torch.from_numpy(parent_of.astype(np.int32)).to(
            g.device),
        num_original=n, mdt=mdt, num_children=n_children)
