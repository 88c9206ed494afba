"""Export LPIPS (net-lin, VGG16) weights into the ``.npz`` that
``--lpips_weights`` reads, from two local files (the counterpart of the
JAX package's ``export_lpips_weights`` script, without its download
branch):

    python -m nerfool_tpu_torch.export_lpips_weights \\
        --vgg_pth vgg16-397923af.pth --lpips_pth vgg.pth [--out lpips_vgg.npz]

``vgg16-397923af.pth`` is torchvision's VGG16 IMAGENET1K_V1 state dict and
``vgg.pth`` pip-lpips' v0.1 lin-head checkpoint; both are carried in by
hand. The arrays go through ``metrics/lpips.convert_lpips_torch_state`` and
``save_lpips_weights``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from nerfool_tpu_torch.metrics.lpips import (convert_lpips_torch_state,
                                             save_lpips_weights)


def params_from_files(vgg_pth, lpips_pth):
    """The flax-layout LPIPS tree from the two state-dict files."""
    vgg_sd = torch.load(vgg_pth, map_location="cpu", weights_only=True)
    if not any(k.startswith("features.") for k in vgg_sd):
        sys.exit(f"{vgg_pth} does not look like a torchvision VGG16 "
                 "state_dict (no 'features.*' keys)")
    feats = {k[len("features."):]: v for k, v in vgg_sd.items()
             if k.startswith("features.")}
    lins = torch.load(lpips_pth, map_location="cpu", weights_only=True)
    missing = [f"lin{i}.model.1.weight" for i in range(5)
               if f"lin{i}.model.1.weight" not in lins]
    if missing:
        sys.exit(f"{lpips_pth} does not look like a pip-lpips v0.1 'vgg' "
                 f"checkpoint (missing {missing})")
    return convert_lpips_torch_state(feats, lins)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter, epilog=__doc__)
    ap.add_argument("--out", default="lpips_vgg.npz")
    ap.add_argument("--vgg_pth", required=True,
                    help="torchvision vgg16 state_dict (vgg16-397923af.pth)")
    ap.add_argument("--lpips_pth", required=True,
                    help="pip-lpips v0.1 vgg lin checkpoint (vgg.pth)")
    args = ap.parse_args(argv)
    save_lpips_weights(params_from_files(args.vgg_pth, args.lpips_pth),
                       args.out)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
