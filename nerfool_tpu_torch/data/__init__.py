"""Dataset registry + training-mix factory.

Equivalent of reference ibrnet/data_loaders/__init__.py:27-36 and
create_training_dataset.py:100-134: named dataset lookup and weighted mixing of
multiple training datasets. The weighted mixing is a seeded host-side sampler
(no torch WeightedRandomSampler / DistributedSamplerWrapper — data-parallel
sharding happens on-device over rays, not over loader processes).
"""
from __future__ import annotations

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, Loader, make_camera
from nerfool_tpu_torch.data.deepvoxels import DeepVoxelsDataset
from nerfool_tpu_torch.data.llff import LLFFDataset
from nerfool_tpu_torch.data.llff_render import LLFFRenderDataset
from nerfool_tpu_torch.data.llff_test import LLFFTestDataset
from nerfool_tpu_torch.data.nerf_synthetic import NerfSyntheticDataset
from nerfool_tpu_torch.data.synthetic import SyntheticDataset


def _lazy(name):
    def factory(*a, **k):
        import importlib

        mod, cls = name.rsplit(".", 1)
        return getattr(importlib.import_module(mod), cls)(*a, **k)

    return factory


dataset_dict = {
    "llff": LLFFDataset,
    "llff_test": LLFFTestDataset,
    "llff_render": LLFFRenderDataset,
    "nerf_synthetic": NerfSyntheticDataset,
    "deepvoxels": DeepVoxelsDataset,
    "synthetic": SyntheticDataset,
    "ibrnet_collected": _lazy("nerfool_tpu_torch.data.ibrnet_collected.IBRNetCollectedDataset"),
    "google_scanned": _lazy("nerfool_tpu_torch.data.google_scanned.GoogleScannedDataset"),
    "realestate": _lazy("nerfool_tpu_torch.data.realestate.RealEstateDataset"),
    "spaces": _lazy("nerfool_tpu_torch.data.spaces.SpacesFreeDataset"),
    "shiny": _lazy("nerfool_tpu_torch.data.shiny.ShinyDataset"),
}


class MixDataset(Dataset):
    """Weighted mixture over several datasets (samples drawn with replacement
    according to per-dataset weights, seeded)."""

    def __init__(self, datasets, weights, seed=0, virtual_len=1_000_000):
        assert len(datasets) == len(weights)
        self.datasets = datasets
        w = np.asarray(weights, dtype=np.float64)
        self.weights = w / w.sum()
        self.rng = np.random.RandomState(seed)
        self.virtual_len = virtual_len

    def __len__(self):
        return self.virtual_len

    def __getitem__(self, idx):
        d = self.rng.choice(len(self.datasets), p=self.weights)
        ds = self.datasets[d]
        return ds[self.rng.randint(len(ds))]


def create_training_dataset(args, seed=0, **kwargs):
    """'a+b+c' dataset spec -> a single (possibly mixed) training dataset.

    Mirrors the reference semantics: one dataset passes through; multiple
    datasets mix either uniformly over samples (weights unset -> sizes) or by
    explicit --dataset_weights. ``kwargs`` go to every dataset's constructor
    (``--dataset_kwargs``).
    """
    names = args.train_dataset.split("+")
    scenes = getattr(args, "train_scenes", ())
    if len(names) == 1:
        return dataset_dict[names[0]](args, mode="train", scenes=scenes,
                                      **kwargs)
    datasets = [dataset_dict[n](args, mode="train", scenes=scenes, **kwargs)
                for n in names]
    weights = list(getattr(args, "dataset_weights", []) or [])
    if not weights:
        sizes = np.array([min(len(d), 10**6) for d in datasets], dtype=np.float64)
        weights = (sizes / sizes.sum()).tolist()
    assert abs(sum(weights) - 1.0) < 1e-3 or len(weights) == len(datasets)
    return MixDataset(datasets, weights, seed=seed)
