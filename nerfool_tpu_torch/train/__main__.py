"""Backbone training on the port, the counterpart of ``scripts/train.py``:
plain training, or adversarial training with ``--use_adv_train``, of IBRNet
or GNT, one process on one card, or with ``--distributed`` one process per
card:

    python -m nerfool_tpu_torch.train --config configs/ibrnet/pretrain.txt \\
        [--use_adv_train --adv_iters 3 --epsilon 8 --adv_lr 2] \\
        [--backbone gnt ... --gnt_fused_attn on] [--device cuda] [--seed 0] \\
        [--n_iters N --i_print 100 --i_weights 10000 --i_img 500] \\
        [--no_reload] [--dataset_kwargs JSON]
    torchrun --nproc_per_node N -m nerfool_tpu_torch.train --distributed ...

Runs on the card unless ``--device cpu``. Writes ``args.txt``,
``config.txt``, ``code_snapshot.zip``, ``train_scalars.jsonl``, the
``images/`` panels and ``model_%06d.pth`` checkpoints to
``<out_dir>/<expname>/``, and resumes from the newest checkpoint there
unless ``--no_reload``. ``--gnt_fused_attn on`` sends GNT's ray attention
through the fused kernel (``ops/ray_attention.py``), forward and backward
with the weight gradients. ``--ckpt_path ''`` starts from weights drawn
from ``--seed``, which also seeds the steps' random draws.

``--distributed`` joins the process group (``parallel/distributed.py``:
the env:// variables of the launcher, or ``--distributed_init_method``;
NCCL on the card, gloo on the CPU; ``LOCAL_RANK`` picks the card). Each rank
streams its own views (loader seed ``host_seed(777)``) and draws
(``host_seed(--seed)``), the gradients are averaged over the ranks before
Adam, and rank 0 alone writes the run files, logs and checkpoints. A world
of one rank trains as without the flag.
"""
from __future__ import annotations

import os

from nerfool_tpu_torch.config import port_parser


def parse_args(argv=None):
    return port_parser().parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns the ``Trainer``."""
    args = parse_args(argv)
    import torch

    from nerfool_tpu_torch.data import create_training_dataset
    from nerfool_tpu_torch.data.base import Loader
    from nerfool_tpu_torch.device import resolve_device
    from nerfool_tpu_torch.engine import render_config_from_args
    from nerfool_tpu_torch.models.bundle import create_model
    from nerfool_tpu_torch.parallel.distributed import (host_seed, initialize,
                                                        is_main_process,
                                                        local_device)
    from nerfool_tpu_torch.parallel.mesh import ray_split
    from nerfool_tpu_torch.train.trainer import (Trainer,
                                                 train_config_from_args)
    from nerfool_tpu_torch.utils.logging import (ScalarLogger,
                                                 save_code_snapshot,
                                                 save_run_config)

    split = None
    if args.distributed:
        rank, world = initialize(args)
        split = ray_split()
        print(f"process {rank}/{world}")
    device = resolve_device(local_device(args.device) if args.distributed
                            else args.device)
    main = is_main_process()
    dataset = create_training_dataset(args, **args.dataset_kwargs)
    sample = dataset[0]
    h, w = int(sample["camera"][0]), int(sample["camera"][1])
    bundle = create_model(args=args, seed=args.seed, device=device)
    render_cfg = render_config_from_args(args, "train", device)
    cfg = train_config_from_args(args, h, w, sample["src_rgbs"].shape[0])
    out_dir = os.path.join(args.out_dir, args.expname)
    if main:
        save_run_config(out_dir, args)
        save_code_snapshot(out_dir)
    trainer = Trainer(bundle, render_cfg, cfg, out_dir=out_dir,
                      chunk_size=args.chunk_size, split=split)
    if not args.no_reload:
        start = trainer.load_latest(load_opt=not args.no_load_opt)
        print(f"resuming from step {start}")

    # each rank its own view stream (rank 0's is the one-process stream)
    loader = iter(Loader(dataset, shuffle=True, seed=host_seed(777),
                         num_workers=args.workers, infinite=True))
    # i_img panels render whole views of a second stream of the train split
    val_loader = iter(Loader(dataset, shuffle=True, seed=880, num_workers=1,
                             infinite=True))
    logger = ScalarLogger(out_dir, "train") if main else None
    try:
        trainer.train(loader, args.n_iters,
                      generator=torch.Generator(device=device).manual_seed(
                          host_seed(args.seed)),
                      i_print=args.i_print, i_weights=args.i_weights,
                      log_fn=print if main else (lambda *a: None),
                      i_img=args.i_img if main else 0, val_iter=val_loader,
                      logger=logger)
        if main:
            trainer.save(trainer.start_step + args.n_iters)
    finally:
        if logger is not None:
            logger.close()
        loader.close()
        val_loader.close()
    return trainer


if __name__ == "__main__":
    main()
