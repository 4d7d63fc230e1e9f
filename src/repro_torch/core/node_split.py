"""Node splitting (paper §III-B): the histogram heuristic that picks the
maximum degree threshold (MDT).  ``split_graph`` and the split-graph
container come with the NS strategy (ROADMAP.md A6).
"""

from __future__ import annotations

import numpy as np


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
