"""The port's expert-parallel MoE dispatch (``repro_torch.moe.sharded``)
against the JAX reference, on the CPU.

The reference's own sharded dispatch needs a device mesh and fails under
the installed jax (``tests/test_moe_sharded.py``, ROADMAP C), so the port
is held the way that file holds the reference: against the reference's
single-device ``moe_dispatch(method="padded")`` at a capacity where
nothing drops, within 1e-5 (``tests/test_moe_sharded.py``'s bound; the
same products, summed in another order), on that file's inputs.  Over
2, 4 and 8 shards held in one process, and over two gloo ranks of
``tests/torch_shard_ranks.py`` (one shard each), which must equal the
one-process run.  ``_positions_sorted`` and ``pad_experts`` are pure
``jnp`` in the reference and are held bit for bit.  The smoke
``deepseek_v3_671b`` model (``moe_impl="shard_map"``) under
``use_group`` is held to the reference's single-device model within
``tests/test_torch_models.py``'s float32 rule.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.moe import balancing as jb
from repro.moe import sharded as jsh
from repro_torch.configs import get_config
from repro_torch.core.shard import ShardGroup, shard_group
from repro_torch.models.moe import moe_ffn
from repro_torch.moe import balancing as tb
from repro_torch.moe import sharded as tsh
from test_torch_mla import close, run_both

ROOT = Path(__file__).resolve().parents[1]
B, S, D, E, K, F = 4, 16, 32, 8, 2, 64
TOL = 1e-5
j_topk_route = jax.jit(jb.topk_route, static_argnums=1)


def _inputs(seed: int = 0):
    """``tests/test_moe_sharded.py``'s inputs, as numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, D)) * 0.2).astype(np.float32)
    logits = (rng.standard_normal((B, S, E)) * 2).astype(np.float32)
    wp = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for k, s in [("w_up", (E, D, F)), ("w_gate", (E, D, F)),
                       ("w_down", (E, F, D))]}
    return x, logits, wp


def _oracle(x, logits, wp, num_experts):
    """The reference's route and single-device dropless padded dispatch:
    (weights, ids, y) as numpy."""
    w, ids, _ = j_topk_route(jnp.asarray(logits), K)
    y, _ = jb.moe_dispatch(jnp.asarray(x), ids, w,
                           {k: jnp.asarray(v) for k, v in wp.items()},
                           num_experts=num_experts, capacity=S * K,
                           method="padded")
    return np.asarray(w), np.asarray(ids), np.asarray(y)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def oracle():
    x, logits, wp = _inputs()
    return x, wp, _oracle(x, logits, wp, E)


# ---------------------------------------------------------------------------
# bookkeeping, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,a", [(8, 32), (40, 96), (256, 64), (3, 1)])
def test_positions_sorted_match_reference(e, a):
    ida = np.random.default_rng(e * a).integers(0, e, (3, a)).astype(np.int32)
    want = np.asarray(jsh._positions_sorted(jnp.asarray(ida)))
    got = tsh._positions_sorted(_t(ida).long())
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), tb._positions(_t(ida), e)[0].numpy())


@pytest.mark.parametrize("e,multiple", [(7, 2), (40, 16), (8, 4), (5, 8)])
def test_pad_experts_matches_reference(e, multiple):
    x, logits, wp = _inputs(e)
    wp = {k: v[:min(e, E)].repeat(-(-e // E), 0)[:e] for k, v in wp.items()}
    lg = np.random.default_rng(e).standard_normal((B, S, e)).astype(
        np.float32)
    jw, jl, je = jsh.pad_experts({k: jnp.asarray(v) for k, v in wp.items()},
                                 jnp.asarray(lg), e, multiple)
    tw, tl, te = tsh.pad_experts({k: _t(v) for k, v in wp.items()}, _t(lg),
                                 e, multiple)
    assert te == je and te % multiple == 0
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for k in wp:
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))


# ---------------------------------------------------------------------------
# the dispatch over held shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_dispatch_matches_oracle(oracle, shards):
    x, wp, (w, ids, want) = oracle
    got = tsh.sharded_moe_dispatch(
        _t(x), _t(ids), _t(w), {k: _t(v) for k, v in wp.items()},
        group=shard_group(shards, "cpu"), num_experts=E, capacity=S * K)
    close(got.numpy(), want, tol=TOL)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_ep_global_dispatch_matches_oracle(oracle, shards):
    x, wp, (w, ids, want) = oracle
    got = tsh.ep_global_dispatch(
        _t(x), _t(ids), _t(w), {k: _t(v) for k, v in wp.items()},
        group=shard_group(shards, "cpu"), num_experts=E,
        capacity=B * S * K)
    close(got.numpy(), want, tol=TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_padded_indivisible_experts_match(shards):
    """7 experts padded to a multiple of the shards: the route over the
    padded logits, the dispatch over the padded experts, against the
    oracle over the 7 real ones."""
    x, logits, wp = _inputs()
    wp7 = {k: v[:7] for k, v in wp.items()}
    wpp, lgp, ep = jsh.pad_experts({k: jnp.asarray(v) for k, v in
                                    wp7.items()}, jnp.asarray(logits[..., :7]),
                                   7, shards)
    w, ids, _ = j_topk_route(lgp, K)
    want, _ = jb.moe_dispatch(jnp.asarray(x), ids, w,
                              {k: jnp.asarray(v) for k, v in wp7.items()},
                              num_experts=7, capacity=S * K, method="padded")
    tw, tl, te = tsh.pad_experts({k: _t(v) for k, v in wp7.items()},
                                 _t(logits[..., :7]), 7, shards)
    tw_, tid, _ = tb.topk_route(tl, K)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(ids))
    got = tsh.sharded_moe_dispatch(_t(x), tid, tw_, tw,
                                   group=shard_group(shards, "cpu"),
                                   num_experts=te, capacity=S * K)
    close(got.numpy(), np.asarray(want), tol=TOL)


def test_indivisible_experts_raise():
    x, _, wp = _inputs()
    with pytest.raises(ValueError, match="pad_experts"):
        tsh.sharded_moe_dispatch(
            _t(x), torch.zeros(B, S, K, dtype=torch.long),
            torch.ones(B, S, K), {k: _t(v[:7]) for k, v in wp.items()},
            group=shard_group(2, "cpu"), num_experts=7, capacity=4)


def test_drops_follow_the_capacity():
    """At a capacity that drops, the sharded dispatch keeps what the
    single-device ``padded`` policy keeps (per-row positions over all
    experts, whichever shard owns them)."""
    x, logits, wp = _inputs(3)
    w, ids, _ = tb.topk_route(_t(logits), K)
    tw = {k: _t(v) for k, v in wp.items()}
    want, stats = tb.moe_dispatch(_t(x), ids, w, tw, num_experts=E,
                                  capacity=3, method="padded")
    assert float(stats["dropped_frac"]) > 0
    got = tsh.sharded_moe_dispatch(_t(x), ids, w, tw,
                                   group=shard_group(4, "cpu"),
                                   num_experts=E, capacity=3)
    close(got.numpy(), want.numpy(), tol=TOL)


# ---------------------------------------------------------------------------
# two gloo ranks, one shard each
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory, oracle):
    x, wp, (w, ids, _) = oracle
    tmp = tmp_path_factory.mktemp("moe_ranks")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, x=x, ids=ids.astype(np.int64), w=w, capacity=S * K,
             ep_capacity=B * S * K, **wp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_shard_ranks.py"),
         "--rank", str(r), "--world", "2", "--store", str(tmp / "store"),
         "--inputs", str(inputs), "--out", str(tmp / f"rank{r}.npz"),
         "--what", "moe"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def test_two_gloo_ranks_match_one_process(oracle, ranks):
    x, wp, (w, ids, want) = oracle
    tw = {k: _t(v) for k, v in wp.items()}
    one = tsh.sharded_moe_dispatch(_t(x), _t(ids), _t(w), tw,
                                   group=shard_group(2, "cpu"),
                                   num_experts=E, capacity=S * K).numpy()
    ep = tsh.ep_global_dispatch(_t(x), _t(ids), _t(w), tw,
                                group=shard_group(2, "cpu"), num_experts=E,
                                capacity=B * S * K).numpy()
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["sharded"], one)
        np.testing.assert_array_equal(out["ep"], ep[r * 2:(r + 1) * 2])
        close(out["sharded"], want, tol=TOL)


# ---------------------------------------------------------------------------
# the MoE layer and the model under use_group
# ---------------------------------------------------------------------------

def test_use_group_sets_and_restores_the_group():
    assert tsh.ACTIVE_GROUP is None
    g2, g4 = shard_group(2, "cpu"), shard_group(4, "cpu")
    with tsh.use_group(g2):
        assert tsh.ACTIVE_GROUP is g2
        with tsh.use_group(g4):
            assert tsh.ACTIVE_GROUP is g4
        assert tsh.ACTIVE_GROUP is g2
    assert tsh.ACTIVE_GROUP is None


@pytest.mark.parametrize("serve_ep", [False, True])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_moe_ffn_under_a_group(shards, serve_ep):
    """``moe_ffn`` of the smoke deepseek config under a group: the
    sharded (or ``serve_ep``) branch, zero drop statistics, and, with
    nothing dropping, the single-device layer's output."""
    cfg = get_config("deepseek_v3_671b").smoke(
        dtype="float32", serve_ep=serve_ep,
        moe_capacity_factor=8.0)          # no drop at 40 tokens
    from repro_torch.models.moe import moe_specs
    from repro_torch.models.params import init_params
    params = init_params(moe_specs(cfg), torch.Generator().manual_seed(1))
    x = torch.randn(2, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    want, aux1 = moe_ffn(params, cfg, x)
    with tsh.use_group(shard_group(shards, "cpu")):
        got, aux = moe_ffn(params, cfg, x)
    assert float(aux1["dropped_frac"]) == 0.0
    assert float(aux["dropped_frac"]) == float(aux["padding_waste"]) == 0.0
    close(got.numpy(), want.numpy(), tol=TOL)


def test_granite_experts_are_padded_under_a_group():
    """40 experts over 16 shards: padded to 48, the router's logits too."""
    cfg = get_config("granite_moe_3b_a800m").smoke(
        dtype="float32", num_experts=40, experts_per_token=8,
        moe_impl="shard_map", moe_capacity_factor=6.0)
    from repro_torch.models.moe import moe_specs
    from repro_torch.models.params import init_params
    params = init_params(moe_specs(cfg), torch.Generator().manual_seed(1))
    x = torch.randn(1, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    want, _ = moe_ffn(params, cfg, x)
    with tsh.use_group(shard_group(16, "cpu")):
        got, aux = moe_ffn(params, cfg, x)
    assert aux["router_logits"].shape[-1] == 48
    assert int(aux["ids"].max()) < 40
    close(got.numpy(), want.numpy(), tol=TOL)


def test_sharded_deepseek_model_matches_reference():
    """The smoke deepseek model (``moe_impl="shard_map"``) under a group
    of 4 held shards against the reference's single-device model on the
    same weights: prefill, ragged decode and caches within 1e-4."""
    with tsh.use_group(shard_group(4, "cpu")):
        run = run_both("deepseek_v3_671b")
    for i, (got, want) in enumerate(run["logits"]):
        close(got, want, err_msg=f"call {i}")
    for name, got, want in run["caches"]:
        close(got, want, err_msg=name)


def test_shard_group_all_gather_is_identity_in_one_process():
    t = torch.arange(6).reshape(3, 2)
    assert ShardGroup(2, torch.device("cpu"), (0, 1)).all_gather(t) is t
