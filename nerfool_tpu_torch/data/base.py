"""Dataset base: the canonical sample dict and a torch-free Dataset contract.

Every dataset yields numpy dicts:
  rgb         [H, W, 3] float32 in [0,1]
  camera      [34]  = (H, W, K.flatten(16), c2w.flatten(16))
  rgb_path    str
  src_rgbs    [V, H, W, 3]
  src_cameras [V, 34]
  depth_range [2]  (near, far)
  depth       [H, W]      (optional, GT)
  src_depths  [V, H, W]   (optional, GT)

matching the reference loaders' contract (e.g. reference ibrnet/
data_loaders/llff_test.py:193-208) minus the torch tensors — host data stays
numpy until it crosses into jit.
"""
from __future__ import annotations

import concurrent.futures as _fut
import threading

import numpy as np


class Dataset:
    """Minimal map-style dataset."""

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def make_camera(h, w, intrinsics, c2w):
    return np.concatenate(
        [np.array([h, w], dtype=np.float32),
         np.asarray(intrinsics, dtype=np.float32).reshape(16),
         np.asarray(c2w, dtype=np.float32).reshape(16)]
    ).astype(np.float32)


class Loader:
    """Threaded prefetching iterator over a Dataset.

    The reference leans on torch DataLoader worker *processes* for image
    decoding (cv2/imageio already release the GIL in C++), so a thread pool
    gives the same overlap without pickling samples across processes.
    """

    def __init__(self, dataset, shuffle=False, seed=0, num_workers=4, prefetch=4,
                 infinite=False, skip=0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.infinite = infinite
        self.skip = skip  # leading samples of the order to pass over unloaded

    def _order(self):
        n = len(self.dataset)
        skip = self.skip
        while True:
            idx = self.rng.permutation(n) if self.shuffle else np.arange(n)
            yield from idx[skip:]
            skip = max(0, skip - n)
            if not self.infinite:
                return

    def __iter__(self):
        if self.num_workers <= 0:
            for i in self._order():
                yield self.dataset[i]
            return
        order = self._order()
        with _fut.ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            lock = threading.Lock()

            def submit():
                try:
                    with lock:
                        i = next(order)
                except StopIteration:
                    return None
                return pool.submit(self.dataset.__getitem__, i)

            for _ in range(self.prefetch):
                f = submit()
                if f is not None:
                    pending.append(f)
            while pending:
                f = pending.pop(0)
                yield f.result()
                nf = submit()
                if nf is not None:
                    pending.append(nf)
