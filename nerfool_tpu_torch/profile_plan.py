"""Host time of the BSPG planner at the flagship's frame size.

    python -m nerfool_tpu_torch.profile_plan

Plans the block segment-patch gather of ``configs/ibrnet/eval_llff.txt``
(IBRNet, 8x8 ray blocks, 10 source views) over the 15 cameras of the
procedural ``synthetic`` scene at 756x1008, the flagship's frame, through
``Evaluator.view_render_cfg`` as a whole-frame render does. The planner is
numpy on the host: nothing runs on a device. Prints the host's CPU count,
the seconds, and the plan's patch sizes and slot budgets.
"""
from __future__ import annotations

import os
import time

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "ibrnet", "eval_llff.txt")
DATA = {"n_views": 15, "h": 756, "w": 1008}


def main():
    from nerfool_tpu_torch.engine import Evaluator
    from nerfool_tpu_torch.eval import parse_args

    args = parse_args(["--config", CONFIG, "--eval_dataset", "synthetic",
                       "--eval_scenes", "synthetic", "--ckpt_path", "",
                       "--num_source_views", "10", "--device", "cpu",
                       "--use_bspg", "True"])
    ev = Evaluator(args, dataset_kwargs=DATA, device="cpu", seed=0)
    n_src = int(ev._make_src(ev.test_dataset[0])["cameras"].shape[0])
    t0 = time.perf_counter()
    cfg = ev.view_render_cfg(n_src)
    seconds = time.perf_counter() - t0
    if cfg.bspg_specs is None:
        raise RuntimeError("the planner found no plan")
    print(f"BSPG planning at {DATA['h']}x{DATA['w']}, {DATA['n_views']} "
          f"cameras, {n_src} source slots, {os.cpu_count()} host CPUs: "
          f"{seconds:.2f} s; " + "; ".join(
              f"p={sp.p} blocks {sp.block} groups "
              f"{[(len(v), k) for v, k in sp.groups]}"
              for sp in cfg.bspg_specs), flush=True)


if __name__ == "__main__":
    main()
