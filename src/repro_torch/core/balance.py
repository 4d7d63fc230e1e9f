"""Load-imbalance metrics (paper Fig. 1 / Table I analysis), numpy only.

On a GPU, imbalance shows up as idle threads in a warp; on a TPU it shows
up as masked lanes in a padded batch.  Both are captured by the same
statistic: the ratio of the *max* per-slot work to the *mean*, and the
fraction of issued work that is padding.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import CSRGraph


@dataclasses.dataclass
class BalanceReport:
    strategy: str
    imbalance_factor: float     # max slot work / mean slot work (1.0 ideal)
    padding_waste: float        # fraction of issued lanes that are masked
    slots: int
    useful: int

    def __str__(self):
        return (f"{self.strategy}: imbalance={self.imbalance_factor:.2f}x "
                f"waste={self.padding_waste * 100:.1f}% "
                f"({self.useful}/{self.slots} lanes useful)")


def per_slot_work(strategy: str, frontier_degrees: np.ndarray, *,
                  mdt: int | None = None,
                  work_items: int | None = None) -> np.ndarray:
    """Edges processed per execution slot for one frontier iteration."""
    deg = np.asarray(frontier_degrees, np.int64)
    total = int(deg.sum())
    if strategy == "BS":
        return deg
    if strategy == "EP":
        return np.ones(max(total, 1), np.int64)
    if strategy == "WD":
        t = work_items or max(total, 1)
        per = np.full(t, total // t, np.int64)
        per[: total % t] += 1
        return per
    if strategy == "NS":
        assert mdt is not None
        pieces = np.maximum(1, -(-deg // max(mdt, 1)))
        out = []
        for d, p in zip(deg, pieces):
            q = np.full(p, mdt, np.int64)
            q[-1] = d - (p - 1) * mdt
            out.append(q)
        return np.concatenate(out) if out else np.zeros(0, np.int64)
    if strategy == "HP":
        assert mdt is not None
        return np.minimum(deg, mdt)
    raise ValueError(strategy)


def analyze(strategy: str, frontier_degrees: np.ndarray, *,
            mdt: int | None = None) -> BalanceReport:
    work = per_slot_work(strategy, frontier_degrees, mdt=mdt)
    work = work[work >= 0]
    if work.size == 0 or work.sum() == 0:
        return BalanceReport(strategy, 1.0, 0.0, 0, 0)
    mean = work.mean()
    mx = work.max()
    # padded execution: every slot is issued for `max` lanes
    issued = int(mx) * work.size
    useful = int(work.sum())
    return BalanceReport(
        strategy=strategy,
        imbalance_factor=float(mx / mean) if mean > 0 else 1.0,
        padding_waste=float(1.0 - useful / issued) if issued else 0.0,
        slots=int(work.size),
        useful=useful,
    )


def graph_imbalance(g: CSRGraph) -> BalanceReport:
    """Whole-graph node-based imbalance (Fig. 1 style)."""
    return analyze("BS", g.degrees.cpu().numpy())
