"""Parameter specs, seeded initialisation, and carrying weights across from
the JAX package.

A model describes its parameters once as a nested dict of
:class:`ParamSpec` leaves (shape, dtype name, init rule), as
:mod:`repro.models.params` does, without the sharding specs.
:func:`init_params` materialises them with the reference's rules
(``normal``, ``zeros``, ``ones``, ``scaled`` with fan_in = ``shape[-2]``).
The numbers come from ``torch.Generator`` s, so they are not JAX's: to run
both packages on the same weights, :func:`from_reference` loads the
reference's parameter tree (as numpy arrays) into a port model.
"""

from __future__ import annotations

import dataclasses

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

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


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


def init_params(specs, generator: torch.Generator, device="cpu"):
    """Materialise the spec tree on ``device``.  Leaf *i* (in
    :func:`leaves` order) draws from its own CPU generator seeded from
    ``generator``'s seed and *i*, so a leaf's values do not depend on the
    device or on the other leaves."""
    seed = generator.initial_seed()
    index = {path: i for i, (path, _) in enumerate(leaves(specs))}

    def make(path: str, s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.torch_dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.torch_dtype, device=device)
        std = s.scale
        if s.init == "scaled":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale / np.sqrt(max(fan_in, 1))
        g = torch.Generator().manual_seed(seed * 1_000_003 + index[path])
        a = torch.randn(s.shape, generator=g, dtype=torch.float32) * std
        return a.to(device=device, dtype=s.torch_dtype)

    return map_tree(make, specs)


def to_tensor(arr) -> torch.Tensor:
    """A numpy array as a CPU tensor.  JAX's bfloat16 arrives as an
    ``ml_dtypes`` array that ``torch.from_numpy`` refuses: it is viewed as
    uint16 and reinterpreted, bit for bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_reference(model, tree) -> None:
    """Load the reference's parameter tree (``LanguageModel.param_specs()``
    layout, leaves as numpy arrays) into the port ``model`` in place.

    The reference stacks its periodic body as ``[n_repeats, ...]``; layer
    ``prefix_len + r·period + j`` of the port takes entry ``r`` of body
    block ``j``.  Shapes and dtypes must match the port's exactly."""
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
    with torch.no_grad():
        for path, p in want.items():
            t = to_tensor(got[path])
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(f"{path}: reference {tuple(t.shape)} "
                                 f"{t.dtype}, port {tuple(p.shape)} "
                                 f"{p.dtype}")
            p.copy_(t)
