"""Clean (no-attack) evaluation on the port: render every test view
whole-frame and measure PSNR/SSIM.

    python -m nerfool_tpu_torch.eval --config configs/ibrnet/eval_llff.txt \\
        [--device cuda] [--seed 0] [--max_views N] [--dataset_kwargs JSON]

Flags parse with ``nerfool_tpu.config.config_parser``, as ``scripts/eval.py``
does; the port adds ``--device``, ``--seed`` (random weights when
``--ckpt_path`` is empty), ``--max_views`` and ``--dataset_kwargs`` (a JSON
object of dataset constructor keywords, e.g. the procedural
``synthetic`` scene's size).
"""
from __future__ import annotations

import json

from nerfool_tpu.config import config_parser


def parse_args(argv=None):
    parser = config_parser()
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_views", type=int, default=None)
    parser.add_argument("--dataset_kwargs", type=json.loads, default={})
    args = parser.parse_args(argv)
    args.distributed = False
    args.no_attack = True
    args.view_specific = True  # per-view source sets, as in clean eval
    return args


def main(argv=None):
    args = parse_args(argv)
    from nerfool_tpu_torch.engine import Evaluator

    scene = args.eval_scenes[0] if args.eval_scenes else args.eval_dataset
    evaluator = Evaluator(args, dataset_kwargs=args.dataset_kwargs,
                          device=args.device, seed=args.seed)
    results = evaluator.evaluate(max_views=args.max_views, verbose=True)
    print(results[scene])
    return results


if __name__ == "__main__":
    main()
