"""Graph containers of the PyTorch port.

The same formats as :mod:`repro.core.graph`:

* :class:`CSRGraph` — ``row_ptr [N+1]``, ``col [E]`` and optional
  ``wt [E]``, all int32 tensors on one device, plus the static
  ``num_nodes``/``num_edges``/``max_degree``.  Graphs are built host-side
  in numpy (same dedup, same stable sort as the reference) and then moved
  to their device once.
* :class:`COOGraph` — the per-edge ``src``/``dst``/``wt`` lists that EP
  needs (paper §II-B), plus ``row_ptr`` for its chunked pushes: ``2E``
  (``3E`` weighted) + ``N + 1`` int32, the memory bill the paper holds
  against EP on large graphs (:meth:`COOGraph.device_bytes`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

INF = np.iinfo(np.int32).max // 2  # "infinity" that survives + weight


def resolve_device(device, *, allow_meta: bool = False) -> torch.device:
    """The ``torch.device`` an entry point runs on.  A CUDA request on a
    machine without a usable card raises: the port never quietly carries
    on on the CPU.  ``"meta"`` (shapes only, nothing computed) is admitted
    only with ``allow_meta``, where an abstract model is built for the
    dry run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            f"available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu") and not (allow_meta
                                                and dev.type == "meta"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def _field_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@dataclasses.dataclass
class CSRGraph:
    """CSR graph.  ``row_ptr[n] : row_ptr[n+1]`` index into ``col``/``wt``."""

    row_ptr: torch.Tensor       # [N+1] int32
    col: torch.Tensor           # [E]   int32 — destination node ids
    wt: Optional[torch.Tensor]  # [E]   int32 edge weights (None for BFS)
    num_nodes: int
    num_edges: int
    max_degree: int

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def device_bytes(self) -> int:
        return _field_bytes(self.row_ptr, self.col, self.wt)

    def to(self, device) -> "CSRGraph":
        """This graph on ``device`` (itself when it already lies there)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        return dataclasses.replace(
            self, row_ptr=self.row_ptr.to(dev), col=self.col.to(dev),
            wt=None if self.wt is None else self.wt.to(dev))

    def to_coo(self) -> "COOGraph":
        """Expand CSR to COO, the conversion EP requires: every edge
        carries its source id (the 2E memory cost)."""
        return COOGraph(src=expand_row_ptr(self.row_ptr, self.num_edges),
                        dst=self.col, wt=self.wt, num_nodes=self.num_nodes,
                        num_edges=self.num_edges, max_degree=self.max_degree,
                        row_ptr=self.row_ptr)

    def unweighted(self) -> "CSRGraph":
        """The same graph without weights (every edge counts 1)."""
        return self if self.wt is None else dataclasses.replace(self, wt=None)

    @classmethod
    def from_arrays(cls, row_ptr, col, wt=None, *,
                    device="cuda") -> "CSRGraph":
        """A graph from host CSR arrays — e.g. ``np.asarray(g.row_ptr)``,
        ``np.asarray(g.col)``, ``np.asarray(g.wt)`` of a reference
        ``repro.core.graph.CSRGraph`` — so both packages see the same
        graph."""
        dev = resolve_device(device)
        # copies: the tensors own their memory (a JAX array's buffer is
        # read-only)
        row_ptr = np.array(row_ptr, np.int32)
        col = np.array(col, np.int32)
        if row_ptr.ndim != 1 or row_ptr.size < 1 or col.ndim != 1:
            raise ValueError("row_ptr must be [N+1] and col [E]")
        if int(row_ptr[0]) != 0 or int(row_ptr[-1]) != col.size:
            raise ValueError(
                f"row_ptr must run from 0 to len(col)={col.size}, got "
                f"{int(row_ptr[0])}..{int(row_ptr[-1])}")
        counts = np.diff(row_ptr)
        if (counts < 0).any():
            raise ValueError("row_ptr must be non-decreasing")
        if wt is not None:
            wt = np.array(wt, np.int32)
            if wt.shape != col.shape:
                raise ValueError(f"wt has shape {wt.shape}, col {col.shape}")
        num_nodes = row_ptr.size - 1
        return cls(
            row_ptr=torch.from_numpy(row_ptr).to(dev),
            col=torch.from_numpy(col).to(dev),
            wt=None if wt is None else torch.from_numpy(wt).to(dev),
            num_nodes=int(num_nodes),
            num_edges=int(col.size),
            max_degree=int(counts.max()) if num_nodes else 0,
        )

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray,
                   wt: Optional[np.ndarray], num_nodes: int,
                   sort: bool = True, dedup: bool = False, *,
                   device="cuda") -> "CSRGraph":
        """Build (host-side, numpy) a CSR graph from an edge list, then
        move it to ``device``."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if dedup:
            key = src * num_nodes + dst
            _, idx = np.unique(key, return_index=True)
            src, dst = src[idx], dst[idx]
            if wt is not None:
                wt = np.asarray(wt)[idx]
        if sort:
            order = np.argsort(src, kind="stable")
            src, dst = src[order], dst[order]
            if wt is not None:
                wt = np.asarray(wt)[order]
        counts = np.bincount(src, minlength=num_nodes)
        row_ptr = np.zeros(num_nodes + 1, np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        return cls.from_arrays(row_ptr, dst, wt, device=device)


@dataclasses.dataclass
class COOGraph:
    """COO graph for edge-based parallelism.  Keeps ``row_ptr`` for the
    work-chunked worklist pushes (one output range per node)."""

    src: torch.Tensor           # [E] int32
    dst: torch.Tensor           # [E] int32
    wt: Optional[torch.Tensor]  # [E] int32
    num_nodes: int
    num_edges: int
    max_degree: int
    row_ptr: Optional[torch.Tensor] = None  # [N+1], for chunked pushes

    @property
    def device(self) -> torch.device:
        return self.src.device

    def device_bytes(self) -> int:
        return _field_bytes(self.src, self.dst, self.wt, self.row_ptr)

    def weight_or_one(self) -> torch.Tensor:
        if self.wt is not None:
            return self.wt
        return torch.ones(self.num_edges, dtype=torch.int32,
                          device=self.device)

    def to(self, device) -> "COOGraph":
        """This graph on ``device`` (itself when it already lies there)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self

        def move(t):
            return None if t is None else t.to(dev)
        return dataclasses.replace(
            self, src=move(self.src), dst=move(self.dst), wt=move(self.wt),
            row_ptr=move(self.row_ptr))


def coo_bytes(g: CSRGraph) -> int:
    """What :meth:`CSRGraph.to_coo` would hold on the device, computed
    from the shapes alone (nothing is allocated)."""
    per_edge = 2 if g.wt is None else 3
    return 4 * (per_edge * g.num_edges + g.num_nodes + 1)


def expand_row_ptr(row_ptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """CSR ``row_ptr`` -> the source id of every edge: node ``n`` repeated
    ``degree(n)`` times, zero-degree nodes contributing nothing (the
    reference builds the same array by a scatter-max and a running
    max)."""
    n = row_ptr.numel() - 1
    ids = torch.arange(n, dtype=torch.int32, device=row_ptr.device)
    return torch.repeat_interleave(ids, row_ptr[1:] - row_ptr[:-1],
                                   output_size=num_edges)


def graph_stats(g: CSRGraph) -> dict:
    """Table-II style stats: max / avg / sigma of outdegrees."""
    deg = g.degrees.cpu().numpy()
    return {
        "nodes": g.num_nodes,
        "edges": g.num_edges,
        "max_deg": int(deg.max()) if deg.size else 0,
        "avg_deg": float(deg.mean()) if deg.size else 0.0,
        "sigma_deg": float(deg.std()) if deg.size else 0.0,
    }
