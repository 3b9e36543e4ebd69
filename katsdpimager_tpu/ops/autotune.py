"""Measured-configuration cache for the dense-matmul gridder.

The reference autotunes its CUDA kernel launch shapes per device and
caches the result (grid.py:585-650 via katsdpsigproc).  This tunes the
*graph* shape: band-assembly algorithm and scan group size for
:func:`.mxu_gridder.grid_chunks_dense_impl`.

Tuning is opt-in (``KTPU_AUTOTUNE=1``) because every candidate costs a
fresh XLA compile, and the platform defaults of :mod:`.mxu_gridder` apply
otherwise.  Results persist in a JSON cache keyed by device kind and
geometry at
``~/.cache/katsdpimager_tpu/autotune.json`` (``KTPU_AUTOTUNE_CACHE``
overrides), so the sweep runs once per device/geometry.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

logger = logging.getLogger(__name__)

#: (assembly, group) candidates.
_CANDIDATES = (("tapdict", 128), ("tapdict", 64),
               ("joint", 128), ("onehot", 128), ("matmul", 128),
               ("tapsmm", 128), ("fft", 2048))


def _cache_path() -> str:
    env = os.environ.get("KTPU_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "katsdpimager_tpu", "autotune.json")


def _load_cache() -> dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_cache(cache: dict) -> None:
    path = _cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _key(pixels: int, kernel_width: int, num_pols: int, ts: int,
         mc: int) -> str:
    import jax

    dev = jax.devices()[0]
    kind = getattr(dev, "device_kind", dev.platform)
    return f"{kind}/N{pixels}/K{kernel_width}/P{num_pols}/ts{ts}/mc{mc}"


def _measure(assembly: str, group: int, *, pixels: int, kernel_width: int,
             num_pols: int, ts: int, mc: int, n_vis: int = 1 << 18) -> float:
    """Seconds per gridding call for one candidate on the attached device."""
    import jax
    import jax.numpy as jnp

    from . import mxu_gridder

    K = kernel_width
    rng = np.random.default_rng(0)
    W, O = 8, 8
    kernel = (rng.normal(size=(W, O, K))
              + 1j * rng.normal(size=(W, O, K))).astype(np.complex64)
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n_vis, 2)),
                 -lim, lim).astype(np.int16)
    sub = rng.integers(0, O, size=(n_vis, 2)).astype(np.int16)
    wp = rng.integers(0, W, size=n_vis).astype(np.int16)
    vis = (rng.normal(size=(n_vis, num_pols))
           + 1j * rng.normal(size=(n_vis, num_pols))).astype(np.complex64)
    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub, wp, vis, np.ones((n_vis, num_pols), np.float32),
        pixels=pixels, kernel_width=K, ts=ts, mc=mc)

    kern_j, vis_j = jnp.asarray(kernel), jnp.asarray(plan.vis)
    pj = [jnp.asarray(x) for x in (plan.uv, plan.sub_uv, plan.w_plane,
                                   plan.anchor, plan.valid)]
    dw = jnp.ones(plan.vis.shape, jnp.float32)
    wg = jnp.ones((num_pols, pixels, pixels), jnp.float32)
    ext = mxu_gridder.dense_pad_size(pixels, ts)

    @jax.jit
    def run(kernel, vis):
        gpad = jnp.zeros((num_pols, ext, ext), jnp.complex64)
        return mxu_gridder.grid_chunks_dense_impl(
            gpad, kernel, wg, pj[0], pj[1], pj[2], vis, pj[3], pj[4], dw,
            mxu_gridder.occupied_chunks(pj[4]),
            pixels=pixels, ts=ts, group=group, assembly=assembly)

    jax.block_until_ready(run(kern_j, vis_j))  # compile + warm
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(run(kern_j, vis_j))
    return (time.perf_counter() - t0) / iters


def lookup(*, pixels: int, kernel_width: int, num_pols: int, ts: int,
           mc: int, n_vis: int = 1 << 18) -> dict | None:
    """Cached best config, measuring if ``KTPU_AUTOTUNE=1``; else None."""
    key = _key(pixels, kernel_width, num_pols, ts, mc)
    cache = _load_cache()
    if key in cache:
        return cache[key]
    if os.environ.get("KTPU_AUTOTUNE") != "1":
        return None
    logger.info("autotuning MXU gridder for %s (%d candidates)",
                key, len(_CANDIDATES))
    results = {}
    for assembly, group in _CANDIDATES:
        dt = _measure(assembly, group, pixels=pixels,
                      kernel_width=kernel_width, num_pols=num_pols,
                      ts=ts, mc=mc, n_vis=n_vis)
        results[(assembly, group)] = dt
        logger.info("  assembly=%s group=%d: %.1f ms", assembly, group,
                    dt * 1e3)
    (assembly, group), best = min(results.items(), key=lambda kv: kv[1])
    entry = {"assembly": assembly, "group": group,
             "sec_per_call": round(best, 5)}
    cache = _load_cache()
    cache[key] = entry
    _store_cache(cache)
    logger.info("autotune best for %s: %s", key, entry)
    return entry
