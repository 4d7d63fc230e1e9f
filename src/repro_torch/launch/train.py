"""Training launcher of the port (the counterpart of
:mod:`repro.launch.train`): config -> data-parallel group -> train step
-> fault-tolerant :class:`~repro_torch.runtime.trainer.Trainer`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
        --smoke --device cpu --steps 4 [--ckpt-dir DIR]

On the card drop ``--smoke --device cpu`` (full width, seeded weights).
Under an initialised ``torch.distributed`` (one rank a card) the batch is
split over the ranks and the gradients averaged.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \
        --production --dry-run [--shape train_4k] [--multi-pod]

counts the production step without allocating it
(:func:`repro_torch.launch.dryrun.count_cell`) and prints its FLOPs, bytes
and memory a device; ``--dry-run`` alone counts the ``--batch`` x
``--seq`` step on one card.  ``--production`` without ``--dry-run``
raises ``NotImplementedError``: no 256-rank world exists to run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging

import torch

from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.dryrun import count_cell
from repro_torch.launch.mesh import (ProductionMesh, data_group,
                                     make_production_mesh)
from repro_torch.launch.shapes import SHAPES, ShapeSpec, skip_reason
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import model_param_specs
from repro_torch.models.params import param_count
from repro_torch.runtime.trainer import TrainConfig, Trainer


def stub_frontends(cfg, batch: dict) -> dict:
    """The reference launcher's stubs: zero image embeddings for a vision
    config, the tokens repeated over the codebooks (labels = tokens) for
    an audio config.  Keeps ``tokens`` and ``labels`` only."""
    batch = {k: batch[k] for k in ("tokens", "labels")}
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros(
            (tokens.shape[0], cfg.num_image_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=tokens.device)
    if cfg.family == "audio":
        batch["tokens"] = (tokens[..., None] % cfg.vocab_size).expand(
            *tokens.shape, cfg.num_codebooks)
        batch["labels"] = batch["tokens"]
    return batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train a config of the port")
    ap.add_argument("--arch", required=True, choices=ARCHITECTURES)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--production", action="store_true",
                    help="production mesh (requires the fleet or the "
                         "dry run)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dry-run", action="store_true",
                    help="count the step over meta tensors; never "
                         "allocates parameters")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--override", default=None,
                    help="JSON ModelConfig overrides")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.production:
        if not args.dry_run:
            raise NotImplementedError(
                "--production needs a 256-rank (512 with --multi-pod) "
                "world, which the port does not start; add --dry-run to "
                "count the step without allocating it (the dry run, "
                "ROADMAP A15 item 5)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.override:
        cfg = dataclasses.replace(cfg, **json.loads(args.override))
    if args.dry_run:
        return dry_run(cfg, args)
    group = data_group(args.device)
    if args.batch % group.size:
        raise ValueError(f"batch {args.batch} does not split over "
                         f"{group.size} ranks")
    shape = ShapeSpec("host", seq_len=args.seq, global_batch=args.batch,
                      kind="train")
    print(f"{cfg.name}: {param_count(model_param_specs(cfg)):,} params")
    step_fn = build_train_step(cfg, shape, group)
    pipeline = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                             global_batch=args.batch, seed=0,
                             host_index=group.rank, host_count=group.size)

    def step(state, batch):
        return step_fn(state, stub_frontends(cfg, batch))

    trainer = Trainer(step, step_fn.init_state(), pipeline,
                      TrainConfig(total_steps=args.steps,
                                  checkpoint_every=max(args.steps // 2, 1),
                                  checkpoint_dir=args.ckpt_dir),
                      device=group.device)
    trainer.maybe_restore()
    hist = trainer.run()
    if hist:
        print(f"loss {hist[0].metrics['loss']:.4f} -> "
              f"{hist[-1].metrics['loss']:.4f} over {len(hist)} steps")
    else:
        print(f"no step to run: restored at step {trainer.step}")
    return 0


def dry_run(cfg, args) -> int:
    """``--dry-run``: the counts of ``cfg``'s step at ``--shape`` on the
    production mesh (with ``--production``), else at ``--batch`` x
    ``--seq`` on one card; its FLOPs, bytes and memory a device
    printed."""
    if args.production:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        shape = SHAPES[args.shape]
    else:
        mesh = ProductionMesh((1, 1), ("data", "model"))
        shape = ShapeSpec("host", seq_len=args.seq, global_batch=args.batch,
                          kind="train")
    reason = skip_reason(cfg, shape)
    if reason:
        print(f"skipped: {reason}")
        return 0
    rec = count_cell(cfg, shape, mesh)
    print(rec["memory_analysis"])
    print({"flops": rec["per_device_flops"],
           "bytes accessed": rec["per_device_bytes"],
           "bytes_per_device": rec["bytes_per_device"],
           "collective_bytes": rec["collective_bytes_per_device"]})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
