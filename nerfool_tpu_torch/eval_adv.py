"""Adversarial evaluation on the port, the counterpart of
``scripts/eval_adv.py``. With ``--view_specific``: per test view,
``--adv_iters`` attack iterations on the perturbation of the view's own
sources, then the whole-frame render from the perturbed sources. Without it,
the universal attack: one perturbation of the global source set, optimised
over streamed train-split target views, then every test view rendered from
that set. PSNR/SSIM per view and their means.

    python -m nerfool_tpu_torch.eval_adv --config configs/ibrnet/eval_llff.txt \\
        [--view_specific] --adv_iters 1000 --epsilon 8 --use_adam \\
        --adam_lr 1e-3 --adv_lr 1 [--use_pseudo_gt --use_center_view] \\
        [--backbone gnt --gnt_fused_attack True --gnt_fused_attn on \\
         --gnt_fused_vt True] [--device cuda] [--seed 0] [--max_views N] \\
        [--dataset_kwargs JSON]

Runs on the card unless ``--device cpu``. ``--no_attack`` gives the clean
rows of either mode. Results go to ``<eval_dataset>/<expname>/<scene>/
psnr_<scene>.txt``, with ``--i_attack_ckpt N`` the universal attack's state
to ``attack_state.pt`` beside it (resumed from when present); the image
dumps of the JAX evaluator are not ported.
"""
from __future__ import annotations

import os

from nerfool_tpu_torch.config import port_parser


def parse_args(argv=None):
    args = port_parser().parse_args(argv)
    args.distributed = False
    args.det = True  # always deterministic sampling for attacks
    if len(args.eval_scenes) > 1:
        raise SystemExit("eval_adv: only accept single scene")
    return args


def main(argv=None):
    args = parse_args(argv)
    from nerfool_tpu_torch.engine import Evaluator

    scene = args.eval_scenes[0] if args.eval_scenes else args.eval_dataset
    out_dir = os.path.join(args.eval_dataset, args.expname, scene)
    print(f"saving results to {out_dir}...")
    evaluator = Evaluator(args, dataset_kwargs=args.dataset_kwargs,
                          device=args.device, seed=args.seed)
    results = evaluator.evaluate(max_views=args.max_views, verbose=True,
                                 out_dir=out_dir)
    res = results[scene]
    print(f"------{scene}-------\n"
          f"final coarse psnr: {res['coarse_mean_psnr']}, "
          f"final fine psnr: {res['fine_mean_psnr']}\n"
          f"final coarse ssim: {res['coarse_mean_ssim']}, "
          f"final fine ssim: {res['fine_mean_ssim']}\n"
          f"final coarse lpips: {res['coarse_mean_lpips']}, "
          f"final fine lpips: {res['fine_mean_lpips']}")
    return results


if __name__ == "__main__":
    main()
