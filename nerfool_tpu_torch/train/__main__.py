"""Backbone training on the port, the counterpart of ``scripts/train.py``:
plain training, or adversarial training with ``--use_adv_train``, of IBRNet
or GNT, one process on one card.

    python -m nerfool_tpu_torch.train --config configs/ibrnet/pretrain.txt \\
        [--use_adv_train --adv_iters 3 --epsilon 8 --adv_lr 2] \\
        [--backbone gnt ... --gnt_fused_attn on] [--device cuda] [--seed 0] \\
        [--n_iters N --i_print 100 --i_weights 10000 --i_img 500] \\
        [--no_reload] [--dataset_kwargs JSON]

Runs on the card unless ``--device cpu``. Writes ``args.txt``,
``config.txt``, ``code_snapshot.zip``, ``train_scalars.jsonl``, the
``images/`` panels and ``model_%06d.pth`` checkpoints to
``<out_dir>/<expname>/``, and resumes from the newest checkpoint there
unless ``--no_reload``. ``--gnt_fused_attn on`` sends GNT's ray attention
through the fused kernel (``ops/ray_attention.py``), forward and backward
with the weight gradients. ``--ckpt_path ''`` starts from weights drawn
from ``--seed``, which also seeds the steps' random draws.
"""
from __future__ import annotations

import dataclasses
import os

from nerfool_tpu_torch.config import port_parser


def parse_args(argv=None):
    return port_parser().parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns the ``Trainer``."""
    args = parse_args(argv)
    if args.distributed:
        raise SystemExit(
            "--distributed: multi-process training is not in the port yet "
            "(ROADMAP.md, queue 1, the parallel/ item); without the flag "
            "the trainer runs one process on one card")
    import torch

    from nerfool_tpu_torch.data import create_training_dataset
    from nerfool_tpu_torch.data.base import Loader
    from nerfool_tpu_torch.device import resolve_device
    from nerfool_tpu_torch.engine import render_config_from_args
    from nerfool_tpu_torch.models.bundle import create_model
    from nerfool_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                 aggregator_lr)
    from nerfool_tpu_torch.utils.logging import (ScalarLogger,
                                                 save_code_snapshot,
                                                 save_run_config)

    device = resolve_device(args.device)
    dataset = create_training_dataset(args, **args.dataset_kwargs)
    sample = dataset[0]
    h, w = int(sample["camera"][0]), int(sample["camera"][1])
    bundle = create_model(args=args, seed=args.seed, device=device)
    render_cfg = dataclasses.replace(
        render_config_from_args(args),
        gnt_fused_attn=args.backbone == "gnt" and args.gnt_fused_attn == "on")
    # N_rand scaled by the source-view count, as the reference does
    n_rand = int(1.0 * args.N_rand * args.num_source_views
                 / max(sample["src_rgbs"].shape[0], 1))
    cfg = TrainConfig(
        h=h, w=w, n_rand=n_rand, sample_mode=args.sample_mode,
        center_ratio=args.center_ratio, lrate_feature=args.lrate_feature,
        lrate_mlp=aggregator_lr(args),
        lrate_decay_factor=args.lrate_decay_factor,
        lrate_decay_steps=args.lrate_decay_steps,
        depth_var_loss=args.depth_var_loss,
        use_adv_train=args.use_adv_train, adv_iters=args.adv_iters,
        epsilon=float(args.epsilon), adv_lr=args.adv_lr)
    out_dir = os.path.join(args.out_dir, args.expname)
    save_run_config(out_dir, args)
    save_code_snapshot(out_dir)
    trainer = Trainer(bundle, render_cfg, cfg, out_dir=out_dir,
                      chunk_size=args.chunk_size)
    if not args.no_reload:
        start = trainer.load_latest(load_opt=not args.no_load_opt)
        print(f"resuming from step {start}")

    loader = iter(Loader(dataset, shuffle=True, seed=777,
                         num_workers=args.workers, infinite=True))
    # i_img panels render whole views of a second stream of the train split
    val_loader = iter(Loader(dataset, shuffle=True, seed=880, num_workers=1,
                             infinite=True))
    logger = ScalarLogger(out_dir, "train")
    try:
        trainer.train(loader, args.n_iters,
                      generator=torch.Generator(device=device).manual_seed(
                          args.seed),
                      i_print=args.i_print, i_weights=args.i_weights,
                      i_img=args.i_img, val_iter=val_loader, logger=logger)
        trainer.save(trainer.start_step + args.n_iters)
    finally:
        logger.close()
        loader.close()
        val_loader.close()
    return trainer


if __name__ == "__main__":
    main()
