"""LPIPS (net-lin, VGG16), port of ``nerfool_tpu/metrics/lpips.py``.

The reference's perceptual metric: both protocols it reports (the vendored
TF graph for IBRNet results, pip ``lpips`` for GNT results) compute

  1. the inputs scaled from [0, 1] (or [-1, 1]) with LPIPS' shift and scale,
  2. VGG16's conv features, tapped at relu1_2 / 2_2 / 3_3 / 4_3 / 5_3,
  3. each tap unit-normalised over channels, the squared difference,
  4. 1x1 "lin" convolutions, the spatial mean, the sum over the taps.

VGG is built from ``nn.Conv2d`` (zero "SAME" padding, 2x2 max pools that
floor odd sizes). Weights are external: ``load_lpips_weights`` reads the flat
``.npz`` that either package's ``save_lpips_weights`` writes (flax layout,
``vgg/conv{b}_{c}/kernel`` HWIO) or a ``.pth`` of torchvision's
``features`` and pip-lpips' ``lins`` state dicts; ``LPIPS.load_params``
takes the flax-layout tree, ``LPIPS.params`` gives it back.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfool_tpu_torch.utils import numerics

# VGG16 features: (out_channels, n_convs) per block, a max pool between blocks
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _VGGFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for b, (ch, n_convs) in enumerate(_VGG_BLOCKS):
            for c in range(n_convs):
                self.add_module(f"conv{b}_{c}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x):  # [N, 3, H, W] in [-1, 1]
        taps = []
        for b, (_, n_convs) in enumerate(_VGG_BLOCKS):
            for c in range(n_convs):
                x = F.relu(getattr(self, f"conv{b}_{c}")(x))
            taps.append(x)
            if b < len(_VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2)
        return taps


class LPIPS(nn.Module):
    """``LPIPS(normalize)(pred, gt)`` on [N, H, W, 3] images (NCHW inside)
    -> [N].

    ``normalize=True`` maps [0, 1] inputs to [-1, 1] first (the IBRNet
    results' TF graph); ``normalize=False`` feeds them raw (the GNT results'
    pip-lpips call).
    """

    def __init__(self, normalize=True):
        super().__init__()
        self.normalize = normalize
        self.vgg = _VGGFeatures()
        for i, (ch, _) in enumerate(_VGG_BLOCKS):
            self.add_module(f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT)[:, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[:, None, None],
                             persistent=False)

    def forward(self, pred, gt):
        def prep(im):
            im = im.permute(0, 3, 1, 2)
            if self.normalize:
                im = 2.0 * im - 1.0
            return (im - self.shift) / self.scale

        def unit(f):
            return f / numerics.sqrt(torch.sum(f ** 2, dim=1, keepdim=True)
                                     + 1e-10)

        total = 0.0
        for i, (fp, fg) in enumerate(zip(self.vgg(prep(pred)),
                                         self.vgg(prep(gt)))):
            lin = getattr(self, f"lin{i}")((unit(fp) - unit(fg)) ** 2)
            total = total + torch.mean(lin, dim=(1, 2, 3))
        return total

    def load_params(self, params):
        """Copy a flax-layout tree ({'vgg': {'conv{b}_{c}': {'kernel' HWIO,
        'bias'}}, 'lin{i}': {'kernel' [1, 1, C, 1]}}) into the module."""
        def f2t(w):  # HWIO -> OIHW, the inverse of the JAX package's t2f
            return torch.as_tensor(np.asarray(w).transpose(3, 2, 0, 1))

        sd = {}
        for name, p in params["vgg"].items():
            sd[f"vgg.{name}.weight"] = f2t(p["kernel"])
            sd[f"vgg.{name}.bias"] = torch.as_tensor(np.asarray(p["bias"]))
        for i in range(len(_VGG_BLOCKS)):
            sd[f"lin{i}.weight"] = f2t(params[f"lin{i}"]["kernel"])
        self.load_state_dict(sd)
        return self

    def params(self):
        """The module's weights as a flax-layout tree of numpy arrays."""
        t2f = lambda w: w.detach().cpu().numpy().transpose(2, 3, 1, 0)
        out = {"vgg": {}}
        for b, (_, n_convs) in enumerate(_VGG_BLOCKS):
            for c in range(n_convs):
                conv = getattr(self.vgg, f"conv{b}_{c}")
                out["vgg"][f"conv{b}_{c}"] = {
                    "kernel": t2f(conv.weight),
                    "bias": conv.bias.detach().cpu().numpy()}
        for i in range(len(_VGG_BLOCKS)):
            out[f"lin{i}"] = {"kernel": t2f(getattr(self, f"lin{i}").weight)}
        return out


def convert_lpips_torch_state(vgg_features_sd, lins_sd):
    """torch weights -> the flax-layout tree.

    :param vgg_features_sd: torchvision vgg16 ``features`` state_dict (keys
        '0.weight', '2.weight', ...: torchvision's layer indices)
    :param lins_sd: pip-lpips lin state_dict (keys 'lin{i}.model.1.weight')
    """
    t2f = lambda w: np.asarray(w).transpose(2, 3, 1, 0)
    params = {"vgg": {}}
    ti = 0  # torchvision's index of the layer: conv, relu, ..., maxpool
    for b, (_, n_convs) in enumerate(_VGG_BLOCKS):
        for c in range(n_convs):
            params["vgg"][f"conv{b}_{c}"] = {
                "kernel": t2f(vgg_features_sd[f"{ti}.weight"]),
                "bias": np.asarray(vgg_features_sd[f"{ti}.bias"])}
            ti += 2
        ti += 1
    for i in range(len(_VGG_BLOCKS)):
        params[f"lin{i}"] = {"kernel": t2f(lins_sd[f"lin{i}.model.1.weight"])}
    return params


def load_lpips_weights(path):
    """The flax-layout tree from an ``.npz`` of flat 'a/b/c' keys (see
    ``save_lpips_weights``) or a ``.pth`` holding {'vgg_features', 'lins'}."""
    if str(path).endswith(".npz"):
        params: dict = {}
        with np.load(path) as flat:
            for k in flat.files:
                *parents, leaf = k.split("/")
                d = params
                for p in parents:
                    d = d.setdefault(p, {})
                d[leaf] = flat[k]
        return params
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_lpips_torch_state(ckpt["vgg_features"], ckpt["lins"])


def save_lpips_weights(params, path):
    """Write a flax-layout tree as an ``.npz`` of flat 'a/b/c' keys."""
    flat = {}

    def walk(d, prefix):
        for k, v in d.items():
            kk = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, kk)
            else:
                flat[kk] = np.asarray(v)

    walk(params, "")
    np.savez(path, **flat)
