"""Training through the port against the reference's ``jax.grad``, on the
CPU.

Smoke configs in float32 with one set of weights (the reference's init
rules, drawn with numpy, carried by ``from_reference``) and one numpy
batch: the
port's ``LanguageModel.loss`` and every gradient leaf against
``jax.jit(jax.value_and_grad(model.loss, has_aux=True))`` of the
reference (its gradients carried onto the port's layout by
``reference_leaves``).  Each reference is computed once, in a module
fixture.

Tolerances: the loss within 1e-5 relative; each gradient leaf within a
share of that leaf's largest |g|: 1e-4 for qwen3 (dense GQA), 1e-3 for
deepseek (MLA, MoE, MTP), 2e-3 for mamba2 (SSD) and 5e-3 for granite.
Both are float32 conditioning, measured on these weights and this batch:
granite's reference is 1.9e-3 from its own float64 run (its routers at
random init) and the port 1.5e-3 from the reference.  For mamba2 the
reference run wholly in float64 (its float32 casts included) and the
port's float64 run agree to 6e-13; against it the reference's float32
gradient is 1.4e-4 off (already past 1e-4) and the port's 8.0e-4, so the
two float32 runs land 9.4e-4 apart.  Over batch seeds 1-5 the port's
float32 deviation spans 4.0e-5-8.0e-4 and the reference's 3.1e-5-2.0e-4,
each the closer one on some seeds: the four SSD layers amplify any
float32 rounding (one op alone in float32, the rest in float64, moves the
gradient by up to 1.9e-4: B5's plain version, and 1.8e-4: the RMS norm,
the same code in both), not an op that loses precision.

Jamba (period 8 with several MoE layers) is held by its loss alone,
forward only: it pins the reference's rule that a scanned period adds
only its last block's routing losses.  A three-step run of the train step and a data-parallel step over
two gloo ranks (``tests/torch_shard_ranks.py --what train``) close the
file.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.mesh import make_host_mesh
from repro.launch.shapes import ShapeSpec as JShapeSpec
from repro.launch.steps import build_train_step as j_build_train_step
from repro.launch.steps import make_optimizer as j_make_optimizer
from repro.models.model import LanguageModel as JModel
from repro.moe import balancing as jb
from repro_torch.configs import get_config
from repro_torch.core.shard import shard_group
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import LanguageModel
from repro_torch.models.params import (from_reference, leaves,
                                       opt_state_from_reference,
                                       reference_leaves)
from repro_torch.moe import balancing as tb
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.compression import allreduce_compressed

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 32
GRAD_TOL = {"qwen3_0_6b": 1e-4, "mamba2_780m": 2e-3,
            "deepseek_v3_671b": 1e-3, "granite_moe_3b_a800m": 5e-3}


def _batch(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)
    shape = (B, S) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    return {k: rng.integers(2, cfg.vocab_size, shape).astype(np.int32)
            for k in ("tokens", "labels")}


def _init(specs, seed: int = 0):
    """The reference's init rules (``repro.models.params.init_params``:
    zeros, ones, normal, ``scaled`` by fan-in ``shape[-2]``) drawn with
    numpy, a generator a leaf: op by op, ``jax.random`` takes ~10 s for
    the smoke deepseek."""
    flat, treedef = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: hasattr(x, "pspec"))
    out = []
    for i, s in enumerate(flat):
        if s.init in ("zeros", "ones"):
            a = np.full(s.shape, 0.0 if s.init == "zeros" else 1.0)
        else:
            std = s.scale
            if s.init == "scaled":
                fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
                std = s.scale / np.sqrt(max(fan_in, 1))
            a = np.random.default_rng([seed, i]).standard_normal(
                s.shape) * std
        out.append(jnp.asarray(a.astype(np.float32)).astype(s.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def _models(arch, **overrides):
    jm = JModel(j_get_config(arch).smoke(dtype="float32", **overrides))
    jparams = _init(jm.param_specs())
    tm = LanguageModel(get_config(arch).smoke(dtype="float32", **overrides),
                       device="cpu")
    from_reference(tm, jax.tree_util.tree_map(np.asarray, jparams))
    return jm, jparams, tm


@pytest.fixture(scope="module")
def reference():
    """arch -> (port model, batch, reference loss, its metrics, its
    gradients in the port's layout), computed once each."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jm, jparams, tm = _models(arch)
            batch = _batch(tm.cfg)
            (loss, metrics), grads = jax.jit(jax.value_and_grad(
                jm.loss, has_aux=True))(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[arch] = (tm, batch, float(loss),
                           {k: float(v) for k, v in metrics.items()},
                           reference_leaves(tm, jax.tree_util.tree_map(
                               np.asarray, grads)))
        return cache[arch]
    return get


def _port_loss(tm, batch):
    tm.requires_grad_(True)
    params = dict(leaves(tm.param_tree()))
    total, metrics = tm.loss({k: torch.from_numpy(v).long()
                              for k, v in batch.items()})
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return total, metrics, dict(zip(params, grads))


@pytest.mark.parametrize("arch", sorted(GRAD_TOL))
def test_loss_and_metrics_match_the_reference(reference, arch):
    tm, batch, loss, metrics, _ = reference(arch)
    with torch.no_grad():
        total, got = tm.loss({k: torch.from_numpy(v).long()
                              for k, v in batch.items()})
    assert set(got) == set(metrics)
    np.testing.assert_allclose(float(total), loss, rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", sorted(GRAD_TOL))
def test_every_gradient_leaf_matches_the_reference(reference, arch):
    tm, batch, loss, _, want = reference(arch)
    total, _, grads = _port_loss(tm, batch)
    np.testing.assert_allclose(float(total.detach()), loss, rtol=1e-5)
    assert set(grads) == set(want)
    tol = GRAD_TOL[arch]
    for path, g in grads.items():
        ref = want[path]
        got = np.zeros_like(ref) if g is None else g.numpy()
        assert np.isfinite(got).all(), path
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got - ref).max())
        assert err <= tol * scale, (path, err, scale)


@pytest.mark.parametrize("method", tb.DISPATCH_METHODS)
def test_moe_dispatch_gradients_match_the_reference(method):
    """Every dispatch policy carries the gradient to the tokens, the
    router logits (through the top-k weights and both routing losses) and
    the experts, at a capacity that drops: within 1e-5 of ``jax.grad`` of
    the reference's ``topk_route`` + ``moe_dispatch``."""
    rng = np.random.default_rng(0)
    Bm, Sm, D, E, K, F = 2, 16, 8, 4, 2, 12
    x = rng.standard_normal((Bm, Sm, D)).astype(np.float32)
    logits = rng.standard_normal((Bm, Sm, E)).astype(np.float32)
    wp = {k: (rng.standard_normal(shape) * 0.3).astype(np.float32)
          for k, shape in (("w_up", (E, D, F)), ("w_gate", (E, D, F)),
                           ("w_down", (E, F, D)))}

    def objective(lib, x, logits, wp, arange):
        w, ids, aux = lib.topk_route(logits, K)
        y, _ = lib.moe_dispatch(x, ids, w, wp, num_experts=E, capacity=6,
                                method=method)
        return (y * arange).sum() + aux["lb_loss"] + aux["z_loss"]
    want = jax.grad(lambda *a: objective(jb, *a, jnp.arange(D)),
                    argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(logits),
        {k: jnp.asarray(v) for k, v in wp.items()})
    tx, tl = (torch.from_numpy(a).requires_grad_() for a in (x, logits))
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in wp.items()}
    got = torch.autograd.grad(objective(tb, tx, tl, tw, torch.arange(D)),
                              [tx, tl] + [tw[k] for k in wp])
    for a, b in zip(got, [want[0], want[1]] + [want[2][k] for k in wp]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_jamba_loss_matches_the_reference():
    """Forward only: the loss with its routing losses, where the
    reference adds a period's last block's alone.  At 16 layers the
    smoke config is two periods of 8 (at its 8 layers the reference's
    layer program is 7 prefix layers and a period of 1, which counts
    every layer)."""
    jm, jparams, tm = _models("jamba_1_5_large_398b", num_layers=16)
    batch = _batch(tm.cfg)
    loss, metrics = jax.jit(jm.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert len(tm.aux_layers()) < sum(tm.is_moe)
    with torch.no_grad():
        total, got = tm.loss({k: torch.from_numpy(v).long()
                              for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(loss), rtol=1e-5)
    for k in ("ce_loss", "lb_loss", "z_loss"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)


def test_three_train_steps_match_the_reference():
    """``build_train_step`` (loss, gradients, AdamW with the warm-up
    cosine schedule) three steps on the pipeline's batches against the
    reference's jitted train step: every step's loss and grad norm within
    1e-4 relative."""
    arch = "qwen3_0_6b"
    jcfg = j_get_config(arch).smoke(dtype="float32")
    jm = JModel(jcfg)
    jparams = _init(jm.param_specs())
    mesh = make_host_mesh()
    with mesh:
        built = j_build_train_step(jcfg, JShapeSpec("t", S, B, "train"),
                                   mesh)
        fn = jax.jit(built.fn)
        jstate = {"params": jparams,
                  "opt": j_make_optimizer(jcfg).init(jparams)}
        cfg = get_config(arch).smoke(dtype="float32")
        step = build_train_step(cfg, ShapeSpec("t", S, B, "train"),
                                device="cpu")
        from_reference(step.model, jax.tree_util.tree_map(np.asarray,
                                                          jparams))
        state = step.init_state()
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                             global_batch=B, seed=0)
        for i in range(3):
            batch = {k: v for k, v in pipe.batch_at(i).items()
                     if k in ("tokens", "labels")}
            jstate, jmetrics = fn(jstate, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
            state, metrics = step(state, {k: torch.from_numpy(v).long()
                                          for k, v in batch.items()})
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(metrics[k]),
                                           float(jmetrics[k]), rtol=1e-4,
                                           err_msg=f"step {i} {k}")
    assert int(state["opt"]["step"]) == 3


def test_data_parallel_step_over_two_gloo_ranks(tmp_path):
    """Two ranks, each on its half of the batch, average their gradients:
    the loss, the grad norm, the first moments and the parameters equal
    one process's step on the whole batch within 1e-6.  The compressed
    all-reduce over the two ranks' process group equals it over two
    members held in one process."""
    cfg = get_config("qwen3_0_6b").smoke(dtype="float32")
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(2, cfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    grads = rng.standard_normal((2, 5, 300)).astype(np.float32)
    inputs = tmp_path / "in.npz"
    np.savez(inputs, grads=grads, **batch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_shard_ranks.py"),
         "--rank", str(r), "--world", "2", "--store",
         str(tmp_path / "store"), "--inputs", str(inputs), "--out",
         str(tmp_path / f"rank{r}.npz"), "--what", "train"],
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
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    step = build_train_step(cfg, ShapeSpec("t", 16, 4, "train"),
                            device="cpu")
    state, metrics = step(step.init_state(), {
        k: torch.from_numpy(v).long() for k, v in batch.items()})
    want = {f"metric.{k}": v.numpy() for k, v in metrics.items()}
    want.update({f"param.{k}": v.detach().numpy()
                 for k, v in state["params"].items()})
    want.update({f"m.{k}": v.numpy() for k, v in state["opt"]["m"].items()})
    mean, residual = allreduce_compressed(
        [torch.from_numpy(g) for g in grads], shard_group(2, "cpu"),
        [torch.zeros(5, 300) for _ in range(2)])
    want["compressed.mean"] = mean[0].numpy()
    for r, got in enumerate(ranks):
        want["compressed.residual"] = residual[r].numpy()
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k], w, rtol=1e-6,
                atol=1e-6 * max(float(np.abs(w).max()), 1e-30), err_msg=k)


def test_microbatches_equal_the_whole_batch():
    """``cfg.microbatches = 2``: the gradients of the two halves summed in
    float32 and halved, the metrics averaged; the step equals one over
    the whole batch within 1e-6 (loss, grad norm, first moments,
    parameters)."""
    cfg = get_config("qwen3_0_6b").smoke(dtype="float32")
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, 16)))
             for k in ("tokens", "labels")}
    out = []
    for mb in (1, 2):
        step = build_train_step(dataclasses.replace(cfg, microbatches=mb),
                                ShapeSpec("t", 16, 4, "train"),
                                device="cpu")
        state, metrics = step(step.init_state(), batch)
        out.append((metrics, state))
    (m1, s1), (m2, s2) = out
    for k in ("loss", "ce_loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-6)
    for tree in ("params", "m"):
        a = s1["params"] if tree == "params" else s1["opt"]["m"]
        b = s2["params"] if tree == "params" else s2["opt"]["m"]
        for k in a:
            want = a[k].detach()
            np.testing.assert_allclose(
                b[k].detach().numpy(), want.numpy(), rtol=1e-6,
                atol=1e-6 * max(float(want.abs().max()), 1e-30))


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_opt_state_from_reference(state_dtype):
    """The reference's AdamW state (its moments in the stacked parameter
    layout, a step count) carried onto the port's optimizer state through
    ``from_reference``'s mapping, leaf for leaf and bit for bit."""
    from repro.optim.adamw import AdamW as JAdamW
    jm, jparams, tm = _models("mamba2_780m")
    jopt = JAdamW(state_dtype=state_dtype)
    jstate = jopt.init(jparams)
    rng = np.random.default_rng(8)
    jstate = {"m": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jstate["m"]), "v": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.random(a.shape), a.dtype), jstate["v"]),
        "step": jnp.int32(7)}
    params = dict(leaves(tm.param_tree()))
    state = AdamW(state_dtype=state_dtype).init(params)
    opt_state_from_reference(tm, jax.tree_util.tree_map(np.asarray, jstate),
                             state)
    assert int(state["step"]) == 7
    for key in ("m", "v"):
        want = reference_leaves(tm, jax.tree_util.tree_map(np.asarray,
                                                           jstate[key]))
        for path, t in state[key].items():
            assert np.array_equal(t.float().numpy(),
                                  np.asarray(want[path], np.float32)), path
