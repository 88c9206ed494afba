"""Clean (no-attack) evaluation on the port: render every test view
whole-frame and measure PSNR, SSIM and LPIPS (with ``--lpips_weights``).

    python -m nerfool_tpu_torch.eval --config configs/ibrnet/eval_llff.txt \\
        [--device cuda] [--seed 0] [--max_views N] [--dataset_kwargs JSON]

Results and the image dumps go to ``<eval_dataset>/<expname>_clean/<scene>/``,
as ``python -m nerfool_tpu_torch.eval_adv`` writes them.

Flags parse with the port's own ``config.port_parser`` (the flags and
defaults of ``scripts/eval.py``, plus ``--device``, ``--seed`` (random weights
when ``--ckpt_path`` is empty), ``--max_views`` and ``--dataset_kwargs``, a
JSON object of dataset constructor keywords, e.g. the procedural
``synthetic`` scene's size).
"""
from __future__ import annotations

import os

from nerfool_tpu_torch.config import port_parser


def parse_args(argv=None):
    args = port_parser().parse_args(argv)
    args.distributed = False
    args.no_attack = True
    args.view_specific = True  # per-view source sets, as in clean eval
    return args


def main(argv=None):
    args = parse_args(argv)
    from nerfool_tpu_torch.engine import Evaluator

    scene = args.eval_scenes[0] if args.eval_scenes else args.eval_dataset
    out_dir = os.path.join(args.eval_dataset, args.expname + "_clean", scene)
    evaluator = Evaluator(args, dataset_kwargs=args.dataset_kwargs,
                          device=args.device, seed=args.seed)
    results = evaluator.evaluate(max_views=args.max_views, verbose=True,
                                 out_dir=out_dir)
    print(results[scene])
    return results


if __name__ == "__main__":
    main()
