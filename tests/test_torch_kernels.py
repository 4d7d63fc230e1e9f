"""The port's kernel modules against the JAX reference, on the CPU.

Here a wrapper runs its plain PyTorch version (the CUDA kernels run only on
the card, where ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold each
against its plain version).
Inputs are made with numpy from a seed and handed to both packages; the
tolerance is exact equality (int32 / bool)."""

import dataclasses
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops
from repro.core.strategies import _apply_relax as jax_apply_relax
from repro.core.strategies import wd_relax as jax_wd_relax
from repro.data import rmat_graph as jax_rmat_graph
from repro.kernels import ref as jax_ref
from repro.kernels import relax as jax_relax
from repro.kernels.find_offsets import find_offsets as jax_find_offsets
from repro_torch.core import operators as tops
from repro_torch.core.graph import CSRGraph
from repro_torch.core.strategies import wd_relax
from repro_torch.kernels import find_offsets as tfo
from repro_torch.kernels import opgen
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import relax as trelax

OP_NAMES = ["shortest_path", "min_label", "widest_path", "reach_count"]


def _rng(*key):
    """A stable per-case generator (``hash`` of str is per-process)."""
    return np.random.default_rng(zlib.crc32("-".join(map(str, key)).encode()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(torch_out, jax_out):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))


# ---------------------------------------------------------------------------
# B3 find_offsets — the cases of tests/test_kernels.py
# ---------------------------------------------------------------------------

def _check_b3(prefix_np, cap):
    got = tfo.find_offsets(_t(prefix_np), cap)
    assert got.dtype == torch.int32 and got.shape == (cap,)
    prefix = jnp.asarray(prefix_np, jnp.int32)
    _eq(got, jax_ref.find_offsets_ref(prefix, cap))
    _eq(got, jax_find_offsets(prefix, cap, interpret=True))
    _eq(tref.find_offsets_ref(_t(prefix_np), cap), jax_ref.find_offsets_ref(
        prefix, cap))
    _eq(tkops.wd_find_offsets(_t(prefix_np), cap),
        jax_ref.find_offsets_ref(prefix, cap))


@pytest.mark.parametrize("f", [1, 7, 128, 1000, 4096])
@pytest.mark.parametrize("max_deg", [0, 1, 9, 300])
def test_find_offsets_sweep(f, max_deg):
    deg = _rng("fo", f, max_deg).integers(0, max_deg + 1, f)
    prefix = np.cumsum(deg).astype(np.int32)
    _check_b3(prefix, max(1024, int(prefix[-1])))


def test_find_offsets_all_zero_degrees():
    _check_b3(np.zeros(16, np.int32), 128)


@pytest.mark.parametrize("seed", range(8))
def test_find_offsets_randomized_prefix(seed):
    rng = np.random.default_rng(seed)
    f = int(rng.integers(1, 600))
    deg = rng.integers(0, 12, f)
    deg[rng.random(f) < 0.4] = 0            # zero-work runs: tie cases
    prefix = np.cumsum(deg).astype(np.int32)
    _check_b3(prefix, int(rng.integers(1, 2 * max(int(prefix[-1]), 1) + 64)))


def test_find_offsets_empty_frontier():
    _check_b3(np.zeros(0, np.int32), 64)


@pytest.mark.parametrize("cap", [1, 2, 127, 128, 129, 1024, 1025])
def test_find_offsets_cap_work_edges(cap):
    deg = _rng("cap", cap).integers(0, 7, 200)
    _check_b3(np.cumsum(deg).astype(np.int32), cap)


# ---------------------------------------------------------------------------
# B2 relax_lanes / apply_relax — the cases of tests/test_kernels.py
# ---------------------------------------------------------------------------

def _random_lanes(rng, op, n, lanes):
    dist = rng.integers(0, 60, n).astype(np.int32)
    if op.combine == "min":                 # sprinkle "unreached" values
        dist[rng.random(n) < 0.4] = op.identity
    return (dist, rng.integers(0, n, lanes).astype(np.int32),
            rng.integers(0, n, lanes).astype(np.int32),
            rng.integers(1, 9, lanes).astype(np.int32),
            rng.random(lanes) < 0.7)


def _check_apply_relax(jop, top, arrays):
    n = arrays[0].shape[0]
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [_t(a) for a in arrays]
    upd0 = np.zeros(n, bool)
    want = jax_apply_relax(jargs[0], jnp.asarray(upd0), *jargs[1:], op=jop)
    got = trelax.apply_relax(targs[0], _t(upd0), *targs[1:], op=top)
    for g, w in zip(got, want):
        _eq(g, w)
    return got, jargs, upd0


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("n,lanes", [(3, 2), (100, 500), (257, 2050)])
def test_relax_lanes_matches_reference(opname, n, lanes):
    """apply_relax (B2's plain version + apply_proposal) equals the
    reference's XLA ``_apply_relax`` and its Pallas ``apply_relax``."""
    jop, top = jops.OPERATORS[opname], tops.OPERATORS[opname]
    arrays = _random_lanes(_rng(opname, n, lanes), jop, n, lanes)
    got, jargs, upd0 = _check_apply_relax(jop, top, arrays)
    pallas = jax_relax.apply_relax(jargs[0], jnp.asarray(upd0), *jargs[1:],
                                   op=jop, interpret=True)
    for g, w in zip(got, pallas):
        _eq(g, w)


@pytest.mark.parametrize("opname", OP_NAMES)
def test_relax_lanes_proposal_matches_pallas(opname):
    """B2's plain version returns the reference kernel's own triple:
    ``(proposal, updated, improve)``, identity where nothing improved."""
    jop, top = jops.OPERATORS[opname], tops.OPERATORS[opname]
    dist, src, dst, w, valid = _random_lanes(_rng("prop", opname), jop, 90,
                                             700)
    want = jax_relax.relax_lanes(*(jnp.asarray(a) for a in
                                   (dist, src, dst, w, valid)),
                                 op=jop, interpret=True)
    got = trelax.relax_lanes(*(_t(a) for a in (dist, src, dst, w, valid)),
                             op=top)
    for g, w_ in zip(got, want):
        _eq(g, w_)


def _fold_case(rng, op, n, lanes):
    """Lanes for the fold into ``dist``: destinations drawn from a few
    nodes (many lanes per destination); for ``add`` (whose value domain
    is all of int32) values near the int32 limit, so the fold wraps."""
    dist, src, _, w, valid = _random_lanes(rng, op, n, lanes)
    dst = rng.integers(0, max(n // 8, 1), lanes).astype(np.int32)
    if op.combine == "add":
        dist = rng.integers(2 ** 30, 2 ** 31 - 1, n).astype(np.int32)
    return dist, src, dst, w, valid


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("n,lanes", [(7, 40), (120, 900)])
def test_apply_relax_folds_into_a_running_mask(opname, n, lanes):
    """The fold into ``dist`` (B2's plain version + apply_proposal) with
    duplicate destinations, ``add``'s int32 wrap and a running
    ``updated`` mask that is not empty, against the reference's XLA
    ``_apply_relax`` (which ORs into the given mask); the port sets the
    caller's mask in place."""
    jop, top = jops.OPERATORS[opname], tops.OPERATORS[opname]
    rng = _rng("fold", opname, n, lanes)
    arrays = _fold_case(rng, jop, n, lanes)
    running = rng.random(n) < 0.3
    want = jax_apply_relax(*(jnp.asarray(a) for a in arrays[:1]),
                           jnp.asarray(running),
                           *(jnp.asarray(a) for a in arrays[1:]), op=jop)
    mask = _t(running)
    got = trelax.apply_relax(_t(arrays[0]), mask, *(_t(a) for a in
                                                     arrays[1:]), op=top)
    assert got[1] is mask
    for g, w in zip(got, want):
        _eq(g, w)
    if jop.combine == "add":                 # the fold did wrap
        dist, src, dst, _, valid = arrays
        total = dist.astype(np.int64)
        np.add.at(total, dst, np.where(valid & (dist[src] != 0),
                                       dist[src].astype(np.int64), 0))
        assert (total > np.iinfo(np.int32).max).any()


@pytest.mark.parametrize("opname", OP_NAMES)
def test_apply_relax_folds_like_the_pallas_kernel(opname):
    """The same fold against the reference's Pallas ``apply_relax``
    (``repro.kernels.relax``, interpret mode)."""
    jop, top = jops.OPERATORS[opname], tops.OPERATORS[opname]
    rng = _rng("fold-pallas", opname)
    arrays = _fold_case(rng, jop, 64, 300)
    running = rng.random(64) < 0.3
    jargs = [jnp.asarray(a) for a in arrays]
    want = jax_relax.apply_relax(jargs[0], jnp.asarray(running), *jargs[1:],
                                 op=jop, interpret=True)
    got = trelax.apply_relax(_t(arrays[0]), _t(running),
                             *(_t(a) for a in arrays[1:]), op=top)
    for g, w in zip(got, want):
        _eq(g, w)


def _slack_ops():
    def jupdate(cand, cur):
        return cand + 2 < cur

    def tupdate(cand, cur):
        return cand + 2 < cur
    jop = jops.EdgeOp(name="slack_test", combine="min", identity=jops.INF,
                      source_value=0, message=lambda v, w: v + w,
                      update=jupdate)
    top = tops.EdgeOp(name="slack_test", combine="min", identity=tops.INF,
                      source_value=0, message=lambda v, w: v + w,
                      update=tupdate)
    return jop, top


def test_custom_update_operator_on_cpu_matches_reference():
    jop, top = _slack_ops()
    _check_apply_relax(jop, top, _random_lanes(np.random.default_rng(5),
                                               jop, 90, 400))


def test_custom_operator_has_no_kernel_codes():
    """The CUDA kernels cannot call Python: a custom op resolves to
    ``MSG_CUSTOM`` and its callables lowered to C++ (the update predicate
    in ``repro_op_improves``), for which its own kernels are built; the
    built-ins keep their codes."""
    _, top = _slack_ops()
    assert top.kernel_codes() == (tops.MSG_CUSTOM, 0, torch.int32)
    assert tops.MSG_CUSTOM == 3
    header = opgen.lower(top).header
    assert "repro_op_message(int32_t v, int32_t w)" in header
    assert "repro_op_add(cand, 2)" in header and "#define REPRO_OP_COMB 0" \
        in header
    assert tops.shortest_path.kernel_codes() == (0, 0, torch.int32)
    assert tops.widest_path.kernel_codes() == (2, 1, torch.int32)
    assert tops.reach_count.kernel_codes() == (1, 2, torch.int32)


def test_builtin_with_custom_message_has_no_kernel_codes():
    """The kernel's message follows the callable itself: a built-in whose
    message is swapped for a custom one (same name, combine and identity)
    must not keep the built-in's kernel code; it takes the lowered path,
    whose header holds its own message."""
    top = dataclasses.replace(tops.shortest_path,
                              message=lambda v, w: v + 2 * w)
    assert top.kernel_codes() == (tops.MSG_CUSTOM, 0, torch.int32)
    header = opgen.lower(top).header
    assert "repro_op_mul(2, w)" in header
    assert opgen.lower(top).digest != opgen.lower(
        tops.shortest_path).digest
    same = dataclasses.replace(tops.shortest_path, name="sp_copy")
    assert same.kernel_codes() == tops.shortest_path.kernel_codes()


def test_register_operator_with_contract_checks_raises(monkeypatch):
    """With REPRO_CHECK_CONTRACTS set, registration runs the contract
    checker (repro_torch.analysis.contracts): the slack operator's
    activation test breaks the monoid laws and is refused with the
    reference's rules; a lawful operator is accepted."""
    monkeypatch.setenv("REPRO_CHECK_CONTRACTS", "1")
    jop, top = _slack_ops()
    with pytest.raises(ValueError, match="CT003") as err:
        tops.register_operator(top)
    assert "slack_test" not in tops.OPERATORS
    with pytest.raises(ValueError) as jerr:
        jops.register_operator(jop)
    assert "slack_test" not in jops.OPERATORS
    rules = sorted(set(re.findall(r"\[(CT\d+)\]", str(err.value))))
    assert rules == sorted(set(re.findall(r"\[(CT\d+)\]",
                                          str(jerr.value))))
    good = dataclasses.replace(tops.shortest_path, name="sp_checked")
    try:
        assert tops.register_operator(good) is good
    finally:
        tops.OPERATORS.pop("sp_checked", None)


def test_cpu_tensors_launch_no_kernel():
    before = dict(trelax.LAUNCHES)
    arrays = _random_lanes(np.random.default_rng(1), tops.shortest_path, 50,
                           300)
    trelax.relax_lanes(*(_t(a) for a in arrays))
    tfo.find_offsets(_t(np.arange(5, dtype=np.int32)), 16)
    assert trelax.LAUNCHES == before


# ---------------------------------------------------------------------------
# B1 wd_relax_lanes — merge path fused with the relax
# ---------------------------------------------------------------------------

def _wd_case(weighted, cursor_offset, opname, seed):
    g = jax_rmat_graph(scale=7, edge_factor=5, weighted=weighted, seed=11)
    rng = _rng("wd", weighted, cursor_offset, opname, seed)
    n = g.num_nodes
    row_ptr = np.asarray(g.row_ptr)
    mask = rng.random(n) < 0.3
    cursor = np.full(n, cursor_offset, np.int32)
    deg = np.maximum(np.where(mask, np.diff(row_ptr) - cursor, 0), 0)
    prefix = np.cumsum(deg).astype(np.int32)
    op = jops.OPERATORS[opname]
    dist = rng.integers(0, 40, n).astype(np.int32)
    if op.combine == "min":
        dist[rng.random(n) < 0.3] = op.identity
    arrays = (dist, prefix, (prefix - deg).astype(np.int32),
              (row_ptr[:-1] + cursor).astype(np.int32),
              np.arange(n, dtype=np.int32), np.asarray(g.col))
    wt = np.asarray(g.wt) if weighted else None
    return arrays, wt, int(g.num_edges)


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("cursor_offset", [0, 1])
@pytest.mark.parametrize("weighted", [True, False])
def test_wd_relax_lanes_matches_pallas(weighted, cursor_offset, opname):
    """B1's plain version returns the Pallas kernel's triple, with and
    without a cursor offset (HP's tail)."""
    arrays, wt, cap = _wd_case(weighted, cursor_offset, opname, 0)
    want = jax_relax.wd_relax_lanes(
        *(jnp.asarray(a) for a in arrays),
        None if wt is None else jnp.asarray(wt), cap_work=cap,
        op=jops.OPERATORS[opname], interpret=True)
    got = trelax.wd_relax_lanes(
        *(_t(a) for a in arrays), None if wt is None else _t(wt),
        cap_work=cap, op=tops.OPERATORS[opname])
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("cap_extra", [0, 37])
def test_wd_relax_matches_reference_xla(weighted, cap_extra):
    """The port's ``wd_relax`` (B1 + apply_proposal) equals the
    reference's XLA searchsorted path on a compacted frontier with
    cursors, padding slots (-1) and spare lanes."""
    g = jax_rmat_graph(scale=8, edge_factor=6, weighted=weighted, seed=5)
    tg = CSRGraph.from_arrays(np.asarray(g.row_ptr), np.asarray(g.col),
                              None if g.wt is None else np.asarray(g.wt),
                              device="cpu")
    rng = _rng("wdx", weighted, cap_extra)
    nodes = np.sort(rng.choice(g.num_nodes, 60, replace=False))
    frontier = np.full(64, -1, np.int32)
    frontier[:60] = nodes
    cursor = rng.integers(0, 3, 64).astype(np.int32)
    dist = rng.integers(0, 500, g.num_nodes).astype(np.int32)
    total = int(np.maximum(np.diff(np.asarray(g.row_ptr))[nodes]
                           - cursor[:60], 0).sum())
    cap = total + cap_extra
    want = jax_wd_relax(g, jnp.asarray(dist), jnp.asarray(frontier),
                        jnp.asarray(cursor), cap_work=cap)
    got = wd_relax(tg, _t(dist), _t(frontier), _t(cursor), cap_work=cap)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("opname", OP_NAMES)
@pytest.mark.parametrize("weighted", [True, False])
def test_wd_relax_folds_into_a_running_mask(opname, weighted):
    """The port's ``wd_relax`` given HP's running mask (B1's fold into
    ``dist``), through a frontier with runs of zero-degree slots (cursors
    past the end, as HP's tail has them), against the reference's XLA
    ``wd_relax`` ORed into the same mask."""
    g = jax_rmat_graph(scale=8, edge_factor=6, weighted=weighted, seed=7)
    tg = CSRGraph.from_arrays(np.asarray(g.row_ptr), np.asarray(g.col),
                              None if g.wt is None else np.asarray(g.wt),
                              device="cpu")
    jop, top = jops.OPERATORS[opname], tops.OPERATORS[opname]
    rng = _rng("wdfold", opname, weighted)
    frontier = np.full(160, -1, np.int32)
    frontier[:150] = np.sort(rng.choice(g.num_nodes, 150, replace=False))
    cursor = rng.integers(0, 2, 160).astype(np.int32)
    cursor[20:70] = 1 << 20                  # runs of zero-degree slots
    cursor[90:91] = 1 << 20
    dist = rng.integers(0, 500, g.num_nodes).astype(np.int32)
    if jop.combine == "min":
        dist[rng.random(g.num_nodes) < 0.3] = jop.identity
    running = rng.random(g.num_nodes) < 0.3
    cap = 2048
    want_dist, want_upd = jax_wd_relax(
        g, jnp.asarray(dist), jnp.asarray(frontier), jnp.asarray(cursor),
        cap_work=cap, op=jop)
    mask = _t(running)
    got_dist, got_upd = wd_relax(tg, _t(dist), _t(frontier), _t(cursor),
                                 cap_work=cap, op=top, updated=mask)
    assert got_upd is mask
    _eq(got_dist, want_dist)
    _eq(got_upd, np.asarray(want_upd) | running)


# ---------------------------------------------------------------------------
# what a BS column or HP tile issues on the card
# ---------------------------------------------------------------------------

class _AtenLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the ATen operators that run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _as_if_on_the_card(monkeypatch):
    """Take the wrappers' CUDA branch with CPU tensors and a fake launch
    that records its kernel; returns the list of launched kernels."""
    launched = []
    for counts in ("LAUNCHES", "LANES"):    # the fake launches count apart
        monkeypatch.setattr(trelax, counts, dict(getattr(trelax, counts)))
    monkeypatch.setattr(trelax, "_dispatch", lambda dist, name: True)
    monkeypatch.setattr(trelax._build, "op_library",
                        lambda op: (None, *op.kernel_codes()[:2]))
    monkeypatch.setattr(trelax, "_launch",
                        lambda name, dev, library, *args: launched.append(
                            name))
    return launched


def test_apply_relax_on_the_card_is_one_copy_and_one_launch(monkeypatch):
    """Per BS column or HP tile, ``apply_relax`` on a CUDA tensor issues
    one copy of ``dist`` (the target) and one B2 launch: no proposal
    fill, no zeroed mask, no elementwise fold and no OR."""
    launched = _as_if_on_the_card(monkeypatch)
    dist, src, dst, w, valid = (_t(a) for a in _random_lanes(
        np.random.default_rng(3), tops.shortest_path, 50, 300))
    mask = torch.zeros(50, dtype=torch.bool)
    before = trelax.LAUNCHES["relax_lanes"]
    with _AtenLog() as log:
        out, upd, _ = trelax.apply_relax(dist, mask, src, dst, w, valid)
    assert launched == ["relax_lanes"]
    assert trelax.LAUNCHES["relax_lanes"] == before + 1
    assert upd is mask and out.data_ptr() != dist.data_ptr()
    # the copy, and the uninitialised improve buffer the kernel writes
    assert sorted(log.ops) == ["clone", "empty"]
    slots = [_t(np.array(a, np.int32)) for a in ([3, 9], [0, 3], [0, 4],
                                                  [1, 2])]
    with _AtenLog() as log:
        trelax.wd_apply_relax(dist, mask, *slots, dst, w, cap_work=16)
    assert launched == ["relax_lanes", "wd_relax_lanes"]
    assert sorted(log.ops) == ["clone", "empty"]


def test_bs_column_is_one_launch(monkeypatch):
    """``bs_relax`` launches B2 once per edge column, each through
    ``apply_relax`` (one copy, one launch), and zeroes its mask once."""
    from repro_torch.core.strategies import bs_relax
    g = jax_rmat_graph(scale=6, edge_factor=4, weighted=True, seed=3)
    tg = CSRGraph.from_arrays(np.asarray(g.row_ptr), np.asarray(g.col),
                              np.asarray(g.wt), device="cpu")
    frontier = torch.tensor([1, 5, 9, 30, -1, -1], dtype=torch.int32)
    deg = np.diff(np.asarray(g.row_ptr))[[1, 5, 9, 30]]
    launched = _as_if_on_the_card(monkeypatch)
    with _AtenLog() as log:
        bs_relax(tg, torch.zeros(g.num_nodes, dtype=torch.int32), frontier)
    assert launched == ["relax_lanes"] * int(deg.max()) and deg.max() > 1
    assert log.ops.count("clone") == int(deg.max())
    for banned in ("minimum", "bitwise_or", "logical_or", "full_like"):
        assert banned not in log.ops
