"""Dataset: directory of scenes with a small eviction cache.

Copy of ``raynet_tpu/common/dataset.py`` (Restrepo scenes mapped by
alphabetical order; DTU scans by index; cache of 2 scenes with random
eviction), plus the ``device`` its scenes run their tensor work on.
"""
import os

import numpy as np

from .scene import DTUScene, RestrepoScene


class Dataset:
    def __init__(self, dataset_directory, select_neighbors_based_on="filesystem",
                 device="cuda"):
        self._dataset_directory = dataset_directory
        self._cache = {}
        self._max_cache_size = 2
        self._select_neighbors_based_on = select_neighbors_based_on
        self._device = device

    @property
    def n_scenes(self):
        return len(os.listdir(self._dataset_directory))

    @property
    def scenes(self):
        return sorted(os.listdir(self._dataset_directory))

    def _evict_if_full(self):
        keys = list(self._cache.keys())
        if len(keys) + 1 > self._max_cache_size:
            del self._cache[keys[np.random.randint(len(keys))]]

    def get_scene(self, scene_idx):
        raise NotImplementedError()


class RestrepoDataset(Dataset):
    def __init__(self, dataset_directory, select_neighbors_based_on="filesystem",
                 device="cuda"):
        super().__init__(dataset_directory, select_neighbors_based_on, device)
        self._scene_mapping = dict(enumerate(self.scenes))

    def get_scene(self, scene_idx):
        if scene_idx not in self._scene_mapping:
            raise ValueError(
                "scene_idx must be one of %r" % (sorted(self._scene_mapping),)
            )
        if scene_idx not in self._cache:
            self._evict_if_full()
            self._cache[scene_idx] = RestrepoScene(
                os.path.join(
                    self._dataset_directory, self._scene_mapping[scene_idx]
                ),
                select_neighbors_based_on=self._select_neighbors_based_on,
                device=self._device,
            )
        return self._cache[scene_idx]


class DTUDataset(Dataset):
    def __init__(
        self,
        dataset_directory,
        illumination="max",
        select_neighbors_based_on="filesystem",
        device="cuda",
    ):
        self._illumination = illumination
        super().__init__(dataset_directory, select_neighbors_based_on, device)

    @property
    def n_scenes(self):
        return len(os.listdir(os.path.join(self._dataset_directory, "Rectified")))

    def get_scene(self, scene_idx):
        if scene_idx not in self._cache:
            self._evict_if_full()
            self._cache[scene_idx] = DTUScene(
                self._dataset_directory,
                scene_idx,
                self._illumination,
                select_neighbors_based_on=self._select_neighbors_based_on,
                device=self._device,
            )
        return self._cache[scene_idx]
