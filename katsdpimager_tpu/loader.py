"""Loader registry: dispatch on file type (parity with reference
``loader.py:13-58``)."""

from __future__ import annotations

from typing import Optional

_LOADERS = []


def _registry():
    if not _LOADERS:
        from . import loader_hdf5, loader_katdal, loader_ms, loader_npy

        _LOADERS.extend([loader_npy.LoaderNumpy, loader_hdf5.LoaderHDF5,
                         loader_ms.LoaderMS, loader_katdal.LoaderKatdal])
    return _LOADERS


def load(filename: str, options=None, start_channel: int = 0,
         stop_channel: Optional[int] = None):
    for loader_cls in _registry():
        if loader_cls.match(filename):
            return loader_cls(filename, options or [], start_channel, stop_channel)
    raise ValueError(f"Unable to determine file type of {filename}")


def data_iter(dataset, vis_limit, vis_load, start_channel, stop_channel):
    """Wrap the per-loader iterator with --vis-limit truncation."""
    n = 0
    for chunk in dataset.data_iter(start_channel, stop_channel, vis_load):
        if vis_limit is not None:
            space = vis_limit - n
            if space <= 0:
                return
            if len(chunk["uvw"]) > space:
                for key in ("uvw", "feed_angle1", "feed_angle2"):
                    if key in chunk:
                        chunk[key] = chunk[key][:space]
                for key in ("vis", "weights"):
                    chunk[key] = chunk[key][:, :space]
                chunk["progress"] = chunk["total"]
        n += len(chunk["uvw"])
        yield chunk
