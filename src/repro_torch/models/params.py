"""Parameter specs, seeded initialisation, and carrying weights across from
the JAX package.

A model describes its parameters once as a nested dict of
:class:`ParamSpec` leaves (shape, dtype name, init rule, partition spec),
as :mod:`repro.models.params` does.  :func:`init_params` materialises them
with the reference's rules (``normal``, ``zeros``, ``ones``, ``scaled``
with fan_in = ``shape[-2]``); on the meta device it draws nothing, as
:func:`abstract_params` does, for the dry run.  ``pspec`` is the
reference's ``PartitionSpec`` as a tuple (None, an axis name or a tuple
of them per dimension): the port shards no parameter, but the dry run
reads each leaf's per-device shape from it
(:func:`repro_torch.launch.mesh.shard_shape`).
The numbers come from ``torch.Generator`` s, so they are not JAX's: to run
both packages on the same weights, :func:`from_reference` loads the
reference's parameter tree (as numpy arrays) into a port model.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    dtype: str = "bfloat16"
    init: str = "normal"       # normal | zeros | ones | scaled(fan_in)
    scale: float = 1.0
    pspec: tuple = ()          # the reference's PartitionSpec entries

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def shard_if(dim: int, axis, divisor: int):
    """Shard ``dim`` over ``axis`` only when evenly divisible (the
    reference's rule: indivisible dims stay replicated)."""
    if axis is None or dim % divisor != 0 or dim < divisor:
        return None
    return axis


def leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def map_tree(fn, tree, prefix: str = ""):
    """The tree with every leaf replaced by ``fn(path, leaf)``, called in
    :func:`leaves` order."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], f"{prefix}{k}.")
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_tree(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def param_count(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for _, s in leaves(specs)))


def param_bytes(specs) -> int:
    return int(sum(int(np.prod(s.shape)) * s.torch_dtype.itemsize
                   for _, s in leaves(specs)))


def abstract_params(specs):
    """The spec tree as meta tensors: shapes and dtypes, no storage (the
    dry run never allocates the 671B model)."""
    return map_tree(lambda _, s: torch.empty(s.shape, dtype=s.torch_dtype,
                                             device="meta"), specs)


#: a leaf of more elements is drawn in pieces along its leading axis,
#: a piece of at most this many elements each (a float32 piece is 256 MB)
PIECE = 1 << 26


def _pieces(shape: tuple, seed: int) -> list:
    """``(rows, generator seed)`` of each piece a leaf is drawn in: the
    whole leaf from ``seed`` up to :data:`PIECE` elements, else whole rows
    of the leading axis, piece ``j`` from ``seed`` and ``j``."""
    n = int(np.prod(shape))
    if n <= PIECE or len(shape) < 2:
        return [(slice(None), seed)]
    rows = max(1, PIECE // (n // shape[0]))
    return [(slice(lo, lo + rows), seed * 65_537 + j + 1)
            for j, lo in enumerate(range(0, shape[0], rows))]


def init_params(specs, generator: torch.Generator, device="cpu"):
    """Materialise the spec tree on ``device`` (on ``"meta"``: empty meta
    tensors, nothing drawn).  Leaf *i* (in
    :func:`leaves` order) is drawn on the CPU in float32 by generators
    seeded from ``generator``'s seed and *i* (a large leaf in pieces of
    whole rows, :func:`_pieces`), so a leaf's values do not depend on the
    device or on the other leaves.  The pieces of all leaves are drawn on
    a thread pool into the leaves, so the host holds a float32 piece a
    thread beside the weights (deepseek's ``[256, 7168, 2048]`` experts
    are 15 GB in float32)."""
    if torch.device(device).type == "meta":
        return abstract_params(specs)
    seed = generator.initial_seed()
    out = map_tree(lambda _, s: torch.empty(s.shape, dtype=s.torch_dtype),
                   specs)
    jobs = []
    for i, ((_, s), (_, t)) in enumerate(zip(leaves(specs), leaves(out))):
        if s.init in ("zeros", "ones"):
            t.fill_(0 if s.init == "zeros" else 1)
            continue
        std = s.scale
        if s.init == "scaled":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale / np.sqrt(max(fan_in, 1))
        jobs += [(t[rows], piece_seed, std) for rows, piece_seed in
                 _pieces(tuple(s.shape), seed * 1_000_003 + i)]

    def draw(job) -> None:
        piece, piece_seed, std = job
        g = torch.Generator().manual_seed(piece_seed)
        piece.copy_(torch.randn(piece.shape, generator=g,
                                dtype=torch.float32) * std)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(draw, jobs))
    return map_tree(lambda _, t: t.to(device), out)


def to_tensor(arr) -> torch.Tensor:
    """A numpy array as a CPU tensor.  JAX's bfloat16 arrives as an
    ``ml_dtypes`` array that ``torch.from_numpy`` refuses: it is viewed as
    uint16 and reinterpreted, bit for bit."""
    arr = np.array(arr, order="C")      # a copy; keeps a 0-d leaf 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def reference_leaves(model, tree) -> dict:
    """The reference's parameter-shaped tree (``LanguageModel.param_specs()``
    layout: parameters, gradients or optimizer moments, leaves as numpy
    arrays) as ``{port path: array}`` in the port's layout.

    The reference stacks its periodic body as ``[n_repeats, ...]``; layer
    ``prefix_len + r·period + j`` of the port takes entry ``r`` of body
    block ``j``.  The paths must be exactly the port's."""
    prefix_len, period = model.structure()
    layers = [None] * model.cfg.num_layers
    for i, blk in enumerate(tree["prefix"]):
        layers[i] = blk
    n_repeats = (model.cfg.num_layers - prefix_len) // period
    for j, blk in enumerate(tree["body"]):
        for r in range(n_repeats):
            layers[prefix_len + r * period + j] = map_tree(
                lambda _, a, r=r: np.asarray(a)[r], blk)
    flat = {k: v for k, v in tree.items() if k not in ("prefix", "body")}
    flat["layers"] = layers
    want = dict(leaves(model.param_tree()))
    got = dict(leaves(flat))
    if set(want) != set(got):
        raise ValueError(f"reference tree does not match the port's: "
                         f"missing {sorted(set(want) - set(got))[:5]}, "
                         f"extra {sorted(set(got) - set(want))[:5]}")
    return got


def _load(targets: dict, arrays: dict, what: str) -> None:
    """Copy ``arrays`` (numpy, by path) into the tensors ``targets`` (by
    path) in place; shapes and dtypes must match exactly."""
    with torch.no_grad():
        for path, p in targets.items():
            t = to_tensor(arrays[path])
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(f"{what} {path}: reference "
                                 f"{tuple(t.shape)} {t.dtype}, port "
                                 f"{tuple(p.shape)} {p.dtype}")
            p.copy_(t)


def from_reference(model, tree) -> None:
    """Load the reference's parameter tree (``LanguageModel.param_specs()``
    layout, leaves as numpy arrays) into the port ``model`` in place
    (:func:`reference_leaves`' mapping).  Shapes and dtypes must match the
    port's exactly."""
    _load(dict(leaves(model.param_tree())), reference_leaves(model, tree),
          "parameter")


def opt_state_from_reference(model, opt_state, state: dict) -> None:
    """Carry the reference's AdamW state (``{"m": tree, "v": tree,
    "step": int}``, the trees in the parameter layout, leaves as numpy
    arrays) into the port's optimizer ``state`` (``optim.AdamW.init``'s
    ``{"m": {path: tensor}, "v": {path: tensor}, "step": tensor}``) in
    place, through :func:`from_reference`'s mapping."""
    for key in ("m", "v"):
        _load(state[key], reference_leaves(model, opt_state[key]),
              f"optimizer {key}")
    with torch.no_grad():
        state["step"].fill_(int(np.asarray(opt_state["step"])))
