"""Native visibility dataset, numpy-only form.

The interchange layout of :mod:`.loader_hdf5` as a directory: one ``.npy``
file per array (``uvw``, ``vis``, ``frequencies`` and, when present,
``weights``, ``feed_angle1``, ``feed_angle2``), opened with
``mmap_mode="r"`` so channels and rows are read on demand, plus
``attrs.json`` holding the attributes.  It needs nothing beyond numpy, so
the simulator's datasets open on any host the imager runs on.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import loader_core, loader_hdf5

#: Attribute file that marks a directory as a numpy-form dataset.
ATTRS = "attrs.json"
_ARRAYS = ("uvw", "vis", "weights", "frequencies", "feed_angle1",
           "feed_angle2")
_DTYPES = {"uvw": np.float32, "vis": np.complex64, "weights": np.float32,
           "frequencies": np.float64, "feed_angle1": np.float32,
           "feed_angle2": np.float32}


def write(dirname: str, attrs: dict, **arrays) -> None:
    """Write a dataset directory; ``None`` arrays and attributes are
    omitted."""
    os.makedirs(dirname, exist_ok=True)
    for name, arr in arrays.items():
        if name not in _ARRAYS:
            raise ValueError(f"unknown dataset array {name!r}")
        if arr is not None:
            np.save(os.path.join(dirname, name + ".npy"),
                    np.asarray(arr, _DTYPES[name]))
    with open(os.path.join(dirname, ATTRS), "w") as f:
        json.dump({k: v for k, v in attrs.items() if v is not None}, f)


class LoaderNumpy(loader_hdf5.LoaderHDF5):
    """Reads the directory form; the HDF5 loader's methods work unchanged
    on the dict of memory-mapped arrays."""

    @classmethod
    def match(cls, filename: str) -> bool:
        return os.path.isfile(os.path.join(filename, ATTRS))

    def __init__(self, filename, options, start_channel=0, stop_channel=None):
        loader_core.LoaderBase.__init__(self, filename, options,
                                        start_channel, stop_channel)
        self._file = {
            name: np.load(os.path.join(filename, name + ".npy"),
                          mmap_mode="r")
            for name in _ARRAYS
            if os.path.exists(os.path.join(filename, name + ".npy"))}
        self._uvw = self._file["uvw"]
        self._vis = self._file["vis"]
        self._weights = self._file.get("weights")
        self._freqs = np.asarray(self._file["frequencies"])
        with open(os.path.join(filename, ATTRS)) as f:
            self._attrs = json.load(f)

    def close(self):
        self._file.clear()
