"""The port's data pipeline, checkpoints, trainer and training launcher on
the CPU.

``repro_torch.data.pipeline`` is the port's own copy of the reference's:
its batches must equal the reference's bit for bit (seeds, steps, host
sharding, the prefetching iterator).  Checkpoints round-trip bf16 leaves
exactly (stored as their int16 bits), commit atomically and keep the
latest steps.  The reference's two ``Trainer`` tests
(``tests/test_substrates.py``) are mirrored on tensors, and
``python -m repro_torch.launch.train`` runs in-process at smoke width:
two steps with checkpoints, then a restart that resumes at the last one.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch import shapes as jshapes
from repro_torch.configs import ARCHITECTURES
from repro_torch.checkpoint.store import (AsyncCheckpointer, assign,
                                          latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.data.pipeline import PipelineState, TokenPipeline
from repro_torch.configs import get_config
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import data_group, make_production_mesh
from repro_torch.launch.steps import (batch_specs, build_prefill_step,
                                      build_serve_step)
from repro_torch.models.model import LanguageModel
from repro_torch.runtime.trainer import TrainConfig, Trainer


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (11, 123456)])
def test_pipeline_batches_equal_the_reference(seed, step):
    kw = dict(vocab_size=151936, seq_len=64, global_batch=4, seed=seed)
    got, want = TokenPipeline(**kw).batch_at(step), JPipeline(
        **kw).batch_at(step)
    assert set(got) == set(want) == {"tokens", "labels", "segment_ids"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_host_sharding_and_prefetch_equal_the_reference():
    kw = dict(vocab_size=50, seq_len=8, global_batch=8, seed=2)
    full = TokenPipeline(**kw).batch_at(5)["tokens"]
    parts = []
    for i in range(4):
        mine = TokenPipeline(**kw, host_index=i, host_count=4)
        ref = JPipeline(**kw, host_index=i, host_count=4)
        np.testing.assert_array_equal(mine.batch_at(5)["tokens"],
                                      ref.batch_at(5)["tokens"])
        parts.append(mine.batch_at(5)["tokens"])
    np.testing.assert_array_equal(np.concatenate(parts), full)
    p, r = TokenPipeline(**kw), JPipeline(**kw)
    got = list(p.iterate(start_step=3, stop_step=6))
    want = list(r.iterate(start_step=3, stop_step=6))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    back = TokenPipeline.restore(p.state(4), vocab_size=50, seq_len=8,
                                 global_batch=8)
    assert p.state(4) == PipelineState(seed=2, step=4)
    np.testing.assert_array_equal(back.batch_at(4)["tokens"],
                                  p.batch_at(4)["tokens"])


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 5, generator=g).bfloat16(),
                       "b": torch.randn(5, generator=g)},
            "opt": {"m": {"w": torch.randn(3, 5, generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)},
            "layers": [torch.arange(4, dtype=torch.int64)]}


def test_checkpoint_roundtrip_with_bf16_leaves_and_atomicity(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    save_checkpoint(d, 10, tree, {"note": "x"})
    save_checkpoint(d, 20, tree)
    os.makedirs(os.path.join(d, "step_000000030.tmp"))    # a cut write
    assert latest_step(d) == 20
    assert latest_step(str(tmp_path / "none")) is None
    template = _tree()
    with torch.no_grad():
        for t in (template["params"]["w"], template["opt"]["step"]):
            t.zero_()
    restored, meta = restore_checkpoint(d, 10, template)
    assert meta["extra"]["note"] == "x" and meta["step"] == 10
    assert meta["dtypes"]["params.w"] == "bfloat16"
    for (a, b) in ((restored["params"]["w"], tree["params"]["w"]),
                   (restored["params"]["b"], tree["params"]["b"]),
                   (restored["opt"]["m"]["w"], tree["opt"]["m"]["w"]),
                   (restored["opt"]["step"], tree["opt"]["step"]),
                   (restored["layers"][0], tree["layers"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assign(template, restored)
    assert torch.equal(template["params"]["w"], tree["params"]["w"])
    assert int(template["opt"]["step"]) == 7


def test_async_checkpointer_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    ck = AsyncCheckpointer(d, keep=2)
    tree = {"x": torch.ones(3)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
        tree["x"] += 1                     # the snapshot was taken
    ck.wait()
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(d))
    assert steps == [3, 4] and ck.last_committed == 4
    restored, _ = restore_checkpoint(d, 4, tree)
    assert torch.equal(restored["x"], torch.full((3,), 4.0))


class FlakyStep:
    """Fails once at a given step: a transient fault."""

    def __init__(self, fail_at):
        self.fail_at = fail_at
        self.failed = False

    def __call__(self, state, batch):
        step = int(state["step"])
        if step == self.fail_at and not self.failed:
            self.failed = True
            raise RuntimeError("injected device failure")
        loss = torch.tensor(1.0 / (1 + step))
        return {"step": state["step"] + 1,
                "w": state["w"] * 0.9}, {"loss": loss}


def _state():
    return {"step": torch.tensor(0, dtype=torch.int32),
            "w": torch.tensor(1.0)}


def test_trainer_fault_tolerance(tmp_path):
    pipe = TokenPipeline(vocab_size=10, seq_len=4, global_batch=2, seed=0)
    cfg = TrainConfig(total_steps=10, checkpoint_every=2,
                      checkpoint_dir=str(tmp_path / "ck"), log_every=100)
    step = FlakyStep(fail_at=5)
    tr = Trainer(step, _state(), pipe, cfg)
    history = tr.run()
    assert tr.step == 10
    assert step.failed                       # the fault fired and was healed
    assert latest_step(cfg.checkpoint_dir) == 10
    assert [r.step for r in history] == [0, 1, 2, 3, 4, 4, 5, 6, 7, 8, 9]
    assert int(tr.state["step"]) == 10


def test_trainer_restore_resumes(tmp_path):
    pipe = TokenPipeline(vocab_size=10, seq_len=4, global_batch=2, seed=0)
    d = str(tmp_path / "ck")
    cfg = TrainConfig(total_steps=4, checkpoint_every=2, checkpoint_dir=d,
                      log_every=100)
    step = FlakyStep(fail_at=-1)
    Trainer(step, _state(), pipe, cfg).run()
    cfg2 = dataclasses.replace(cfg, total_steps=6)
    tr2 = Trainer(step, _state(), pipe, cfg2)
    assert tr2.maybe_restore()
    assert tr2.step == 4 and int(tr2.state["step"]) == 4
    tr2.run()
    assert tr2.step == 6
    assert abs(float(tr2.state["w"]) - 0.9 ** 6) < 1e-6


def test_launch_train_smoke_with_a_restart(tmp_path, capsys):
    """``launch.train`` at smoke width on the CPU: two steps, a
    checkpoint each (``--steps 2``: every step), then a run to three steps
    that restores step 2 and takes one more."""
    d = str(tmp_path / "ck")
    args = ["--arch", "qwen3_0_6b", "--smoke", "--device", "cpu", "--seq",
            "32", "--batch", "2", "--ckpt-dir", d]
    assert train_launcher.main(args + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "over 2 steps" in out and latest_step(d) == 2
    loss = [float(x) for x in out.split("loss ")[1].split(" over")[0]
            .split(" -> ")]
    assert all(np.isfinite(loss))
    assert train_launcher.main(args + ["--steps", "3"]) == 0
    assert "over 1 steps" in capsys.readouterr().out
    assert latest_step(d) == 3
    with pytest.raises(NotImplementedError, match="A15 item 5"):
        train_launcher.main(args + ["--production"])


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_launch_train_runs_every_config(arch, capsys):
    """One step of every config at smoke width on the CPU through the
    launcher (a vision config with the stub's zero image embeddings, an
    audio config with its tokens repeated over the codebooks): a finite
    loss."""
    assert train_launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                                "--steps", "1", "--seq", "16", "--batch",
                                "2"]) == 0
    out = capsys.readouterr().out
    loss = float(out.split("loss ")[1].split(" -> ")[0])
    assert "over 1 steps" in out and np.isfinite(loss)


def test_shapes_cells_and_skips_equal_the_reference():
    assert {k: tuple(v.__dict__.values()) for k, v in tshapes.SHAPES.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in jshapes.SHAPES.items()}
    from repro.configs import get_config as j_get_config
    for arch in ARCHITECTURES:
        for name, shape in tshapes.SHAPES.items():
            assert tshapes.skip_reason(get_config(arch), shape) == \
                jshapes.skip_reason(j_get_config(arch), jshapes.SHAPES[name])
    got = tshapes.cells(["mamba2_780m", "qwen3_0_6b"], ["long_500k"])
    assert [(a, s.name) for a, _, s in got] == [
        ("mamba2_780m", "long_500k"), ("qwen3_0_6b", "long_500k")]


def test_batch_specs_and_the_thin_steps():
    """``batch_specs`` gives the stubbed batch's shapes (audio codebooks,
    vision embeddings); ``build_prefill_step``/``build_serve_step`` give
    the greedy tokens of ``forward``/``decode_step``; one process is a
    data group of one; the production mesh is the reference's 16 x 16
    (a plain record: no device, no process group)."""
    shape = tshapes.ShapeSpec("t", 16, 2, "train")
    audio = get_config("musicgen_large").smoke()
    assert batch_specs(audio, shape)["labels"] == ((2, 16, 4), torch.int32)
    vlm = get_config("llama_3_2_vision_11b").smoke()
    specs = batch_specs(vlm, shape)
    assert specs["vision_embeds"] == ((2, 16, 128), torch.bfloat16)
    raw = TokenPipeline(vocab_size=vlm.vocab_size, seq_len=16,
                        global_batch=2).batch_at(0)
    batch = train_launcher.stub_frontends(
        vlm, {k: torch.from_numpy(v) for k, v in raw.items()})
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: (s, torch.int32 if k != "vision_embeds" else torch.bfloat16)
        for k, s in ((k, specs[k][0]) for k in specs)}
    model = LanguageModel(get_config("qwen3_0_6b").smoke(dtype="float32"),
                          device="cpu")
    tokens = torch.randint(2, 500, (2, 8))
    nxt, cache = build_prefill_step(model)({"tokens": tokens},
                                           model.new_cache(2, 12))
    logits, _ = model(tokens, cache=model.new_cache(2, 12))
    assert torch.equal(nxt, logits[:, -1:].argmax(-1))
    tok, _ = build_serve_step(model)(cache, nxt, 8)
    assert tok.shape == (2, 1)
    group = data_group("cpu")
    assert (group.rank, group.size, group.process_group) == (0, 1, None)
    mesh = make_production_mesh()
    assert (mesh.shape, mesh.axis_names, mesh.chips) == (
        (16, 16), ("data", "model"), 256)
