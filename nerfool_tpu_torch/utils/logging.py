"""Run records (port of ``nerfool_tpu/utils/logging.py``): the scalar and
image log of a training run, the resolved flags and config file, and a
snapshot of the sources.

Scalars go to a JSONL stream (no tensorboard here), image panels to PNGs
written by ``utils/vis.write_png`` (the card's machine has no imaging
package).
"""
from __future__ import annotations

import json
import os
import shutil
import time


class ScalarLogger:
    """``<log_dir>/<name>_scalars.jsonl`` records {step, tag, value, wall}
    and ``<log_dir>/images/<tag>_<step>.png`` panels."""

    def __init__(self, log_dir, name="train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_scalars.jsonl")
        self._f = open(self.path, "a")
        self.t0 = time.time()

    def add_scalar(self, tag, value, step):
        self._f.write(
            json.dumps({"step": int(step), "tag": tag, "value": float(value),
                        "wall": time.time() - self.t0}) + "\n")
        self._f.flush()

    def add_scalars(self, scalars: dict, step):
        for k, v in scalars.items():
            self.add_scalar(k, v, step)

    def add_image(self, tag, image, step):
        """image: [H, W, 3] float in [0, 1] or uint8."""
        import numpy as np

        from nerfool_tpu_torch.utils.vis import write_png

        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = (255 * np.clip(image, 0, 1)).astype(np.uint8)
        write_png(os.path.join(img_dir,
                               f"{tag.replace('/', '_')}_{step:08d}.png"),
                  image)

    def close(self):
        self._f.close()


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


def save_code_snapshot(out_dir):
    """Zip the port's sources (Python and CUDA) and ``configs/`` into
    ``<out_dir>/code_snapshot.zip``, so that a run's results stay
    reproducible.

    :return: the zip's path
    """
    import zipfile

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dst = os.path.join(out_dir, "code_snapshot.zip")
    os.makedirs(out_dir, exist_ok=True)
    with zipfile.ZipFile(dst, "w", zipfile.ZIP_DEFLATED) as z:
        for sub in ("nerfool_tpu_torch", "configs"):
            for dirpath, dirnames, filenames in os.walk(os.path.join(root,
                                                                     sub)):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__", "build"))
                for fn in sorted(filenames):
                    if fn.endswith((".py", ".cu", ".txt", ".sh")):
                        p = os.path.join(dirpath, fn)
                        z.write(p, os.path.relpath(p, root))
    return dst
