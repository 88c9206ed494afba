"""Run records (port of ``nerfool_tpu/utils/logging.py`` ``save_run_config``)."""
from __future__ import annotations

import os
import shutil


def save_run_config(out_dir, args):
    """Snapshot the resolved flags as ``args.txt`` and the config file as
    ``config.txt`` (kept if already there), as the reference's train.py
    does."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "args.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k} = {getattr(args, k)}\n")
    cfg = getattr(args, "config", None)
    dst = os.path.join(out_dir, "config.txt")
    if cfg and os.path.isfile(cfg) and not os.path.exists(dst):
        shutil.copy(cfg, dst)
