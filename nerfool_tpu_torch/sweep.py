"""Multi-scene, multi-dataset attack sweep on the port (the counterpart of
the JAX package's ``sweep`` script): runs the universal or view-specific
attack, or the clean eval with ``--no_attack``, over every scene of one or
more eval datasets with one ``engine.Evaluator`` retargeted per scene, and
writes one JSON report.

    python -m nerfool_tpu_torch.sweep --config configs/ibrnet/eval_llff.txt \\
        --eval_dataset llff_test+nerf_synthetic [--view_specific] \\
        --adv_iters 1000 --epsilon 8 --use_adam --adam_lr 1e-3 --adv_lr 1 \\
        [--device cuda] [--seed 0]

Each scene's results go to ``<dataset>/<expname>/<scene>/`` as
``eval_adv`` writes them; the report, keyed ``<dataset>/<scene>`` with each
scene's means and per-view rows, to
``<datasets joined by _>/<expname>/sweep_report.json``. The evaluator keeps
its model and its random stream from scene to scene; ``retarget`` drops the
BSPG plans, which depend on the scene's cameras. In a process group (one
process per card) rank 0 alone writes.
"""
from __future__ import annotations

import json
import os

from nerfool_tpu_torch.config import port_parser

LLFF_SCENES = ["fern", "flower", "fortress", "horns", "leaves", "orchids",
               "room", "trex"]
SYNTHETIC_SCENES = ["chair", "drums", "lego", "hotdog", "materials", "mic",
                    "ship"]
DEEPVOXELS_SCENES = ["armchair", "cube", "greek", "vase"]

SCENES = {
    "llff_test": LLFF_SCENES,
    "nerf_synthetic": SYNTHETIC_SCENES,
    "deepvoxels": DEEPVOXELS_SCENES,
    "synthetic": [""],
}


def main(argv=None):
    """Sweep as the flags say; returns the report."""
    from nerfool_tpu_torch.engine import Evaluator
    from nerfool_tpu_torch.parallel.distributed import is_main_process

    args = port_parser().parse_args(argv)
    report = {}
    ev = None
    for ds in args.eval_dataset.split("+"):
        for scene in SCENES.get(ds, [""]):
            a = port_parser().parse_args(argv)  # fresh flags per scene
            a.eval_dataset = ds
            a.eval_scenes = [scene] if scene else []
            out_dir = os.path.join(ds, args.expname, scene or ds)
            print(f"=== {ds}/{scene} ===", flush=True)
            # one evaluator for the whole sweep: the model is built once
            ev = (Evaluator(a, dataset_kwargs=a.dataset_kwargs,
                            device=a.device, seed=a.seed)
                  if ev is None else ev.retarget(a))
            res = ev.evaluate(max_views=a.max_views, out_dir=out_dir,
                              verbose=True)
            report[f"{ds}/{scene}"] = res[scene or ds]
    if is_main_process():
        out = os.path.join(args.eval_dataset.replace("+", "_"),
                           args.expname, "sweep_report.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
        print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
