"""The port's optimizer, schedules and gradient compression against the
reference (:mod:`repro.optim`, :mod:`repro.runtime.compression`), on the
CPU, fed the same numpy arrays.

Schedules and AdamW are evaluated in float32 as the reference does them:
held to 1e-6 relative (the same float32 operations; XLA may fuse an
expression where PyTorch rounds after each op).  The int8 quantiser is
held bit for bit.  The compressed all-reduce over 4 shards held in one
process is held to the reference run under ``jax.vmap(...,
axis_name="d")`` (its ``shard_map`` path fails under jax 0.9, ROADMAP C)
within 1e-6 relative: the same int32 sum, the mean scale summed in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import clip_by_global_norm as j_clip
from repro.optim.schedules import linear as j_linear
from repro.optim.schedules import warmup_cosine as j_warmup_cosine
from repro.runtime import compression as jc
from repro_torch.core.shard import shard_group
from repro_torch.optim.adamw import AdamW, clip_by_global_norm
from repro_torch.optim.schedules import linear, warmup_cosine
from repro_torch.runtime import compression as tc


@pytest.mark.parametrize("name", ["warmup_cosine", "linear"])
def test_schedules_match_the_reference(name):
    args = (3e-4, 5, 40)
    port = (warmup_cosine if name == "warmup_cosine" else linear)(*args)
    ref = (j_warmup_cosine if name == "warmup_cosine" else j_linear)(*args)
    for step in range(0, 45):
        want = float(ref(jnp.int32(step)))
        np.testing.assert_allclose(port(step), want, rtol=1e-6, atol=0)
    floor = warmup_cosine(1.0, 2, 10, floor=0.1)
    j_floor = j_warmup_cosine(1.0, 2, 10, floor=0.1)
    for step in (0, 1, 2, 6, 10, 20):
        np.testing.assert_allclose(floor(step), float(j_floor(jnp.int32(
            step))), rtol=1e-6)


def _tree(rng, scale=1.0):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32) * scale,
            "b": rng.standard_normal((5,)).astype(np.float32) * scale,
            "e": rng.standard_normal((3, 4, 2)).astype(np.float32) * scale}


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _tree(np.random.default_rng(0))
    want, want_norm = j_clip({k: jnp.asarray(v) for k, v in g.items()},
                             max_norm)
    got, norm = clip_by_global_norm({k: torch.from_numpy(v)
                                     for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_adamw_matches_the_reference_for_three_steps(state_dtype):
    """The same parameters and the same numpy gradients for three steps
    (decay on the matrices only, clipping on, a warm-up schedule): the
    parameters and both moments within 1e-6 after every step."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, scale) for scale in (0.3, 2.0, 0.05)]
    sched = (warmup_cosine(1e-2, 2, 10), j_warmup_cosine(1e-2, 2, 10))
    jopt = JAdamW(learning_rate=sched[1], state_dtype=state_dtype)
    opt = AdamW(learning_rate=sched[0], state_dtype=state_dtype)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tp)
    for g in grads:
        jp, jstate, jmetrics = jopt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        metrics = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             state, tp)
        assert int(state["step"]) == int(jstate["step"])
        np.testing.assert_allclose(float(metrics["lr"]),
                                   float(jmetrics["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                got = state[mom][k]
                assert str(got.dtype).endswith(state_dtype or "float32")
                np.testing.assert_allclose(
                    got.float().numpy(),
                    np.asarray(jstate[mom][k].astype(jnp.float32)),
                    rtol=1e-6, atol=1e-12)


def test_quantize_int8_is_bit_identical():
    g = (np.random.default_rng(2).standard_normal(1000) * 3).astype(
        np.float32)
    g[:256] *= 0                                  # an all-zero block
    jq, js = jc.quantize_int8(jnp.asarray(g))
    q, s = tc.quantize_int8(torch.from_numpy(g))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    deq = tc.dequantize_int8(q, s, g.shape, g.size)
    assert np.array_equal(deq.numpy(), np.asarray(jc.dequantize_int8(
        jq, js, g.shape, g.size)))
    assert np.abs(deq.numpy() - g).max() < np.abs(g).max() / 100


def test_allreduce_compressed_over_four_held_shards():
    """Four shards in one process against the reference vmapped over an
    axis of 4, twice, the second step carrying the first's residuals."""
    rng = np.random.default_rng(3)
    shards = 4
    g = [rng.standard_normal((7, 90)).astype(np.float32)
         * (1 + d) for d in range(shards)]
    g2 = [rng.standard_normal((7, 90)).astype(np.float32)
          for _ in range(shards)]
    ref = jax.vmap(lambda x, r: jc.allreduce_compressed(x, "d", r),
                   axis_name="d")
    jr = jnp.zeros((shards, 7, 90), jnp.float32)
    group = shard_group(shards, "cpu")
    tr = [torch.zeros(7, 90) for _ in range(shards)]
    for step in (g, g2):
        want, jr = ref(jnp.asarray(np.stack(step)), jr)
        got, tr = tc.allreduce_compressed(
            [torch.from_numpy(x) for x in step], group, tr)
        for d in range(shards):
            np.testing.assert_allclose(got[d].numpy(), np.asarray(want[d]),
                                       rtol=1e-6, atol=1e-6 * float(
                                           np.abs(want).max()))
            np.testing.assert_allclose(tr[d].numpy(), np.asarray(jr[d]),
                                       rtol=1e-6, atol=1e-6 * float(
                                           np.abs(jr).max()))


def test_compressed_grad_tree_and_residuals():
    """One process holding one member: the mean is the dequantised
    gradient, the residual what quantisation lost; leaves keep their
    dtypes."""
    grads = {"a": torch.randn(300), "b": torch.randn(4, 70).bfloat16()}
    res = tc.init_residuals(grads)
    assert all(r.dtype == torch.float32 and r.shape == grads[k].shape
               for k, r in res.items())
    out, new = tc.compressed_grad_tree(grads, None, res)
    for k, g in grads.items():
        assert out[k].dtype == g.dtype
        q, s = tc.quantize_int8(g.float())
        deq = tc.dequantize_int8(q, s, g.shape, g.numel())
        assert torch.equal(new[k], g.float() - deq)
