"""Benchmark harness: gridding + FFT throughput per chip.

Prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline", ...}``.

The metric is compressed visibilities gridded per second per chip through
the full dirty-image step — dense-matmul chunked convolutional gridding with W
kernels + FFT + W-correction (see ops/mxu_gridder.py), i.e. the BASELINE's
"Mvis gridded/sec/chip".  The reference publishes no absolute number
(BASELINE.md); it measures the same workload as GGAPS = N_vis *
kernel_width^2 * n_pols / t (tests/imager_bench.py:166-208).
``vs_baseline`` is measured GGAPS relative to 1.0 GGAPS, a representative
figure for the reference's CUDA gridder on a datacentre GPU of its era.

Workload: the production shape — an 8-channel batch (the production
pipelines always dispatch multi-channel batches; the reference's default
channel batch is 16, frontend.py:356-367) of ~2M compressed visibilities
per channel (MeerKAT-64 yields 2016 baselines x 3600 dumps ~= 7.3M raw
visibilities per channel before compression) onto 4k-pixel single-pol
grids, kernel width 60, oversample 8, 32 W planes, 4 W-stacking slices,
clustered UV, natural imaging weights (the CLI default).  Channels run
sequentially inside one dispatch.  Each timing ends in
``block_until_ready``.

Runs only on an NVIDIA GPU: on any other JAX platform it exits non-zero
without a result.  The result names the device (JAX's platform, device
kind and count, and the card's name and power limit from nvidia-smi).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

import jax

from jax import lax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from katsdpimager_tpu.compile_cache import enable_compilation_cache  # noqa: E402


def run_step_bench(cfg, num_channels: int, vis_per_slice: int | None,
                   iters: int = 3) -> dict:
    """Time the multi-channel dirty-image step; returns the result dict.

    Shared by the driver headline (production 4-W-slice shape) and the
    suite's single-slice twin (benchmarks/bench_suite.py)."""
    from katsdpimager_tpu.parallel.multichannel import (
        make_example_batch, single_channel_step,
    )

    batch = make_example_batch(cfg, num_channels,
                               vis_per_slice=vis_per_slice)
    num_vis = int(np.asarray(batch.valid).sum())
    base = single_channel_step(cfg)

    # All batch arrays are explicit jit ARGUMENTS (a closure would embed
    # them as constants in the compiled program).
    @jax.jit
    def step(kernel, vis, *rest_args):
        def one(args):
            kern_c, vis_c, t, ps, mw, uv, sub, wpl, anc, val, wts = args
            residual, _model = base(kern_c, t, ps, mw, uv, sub, wpl, anc,
                                    val, wts, vis_c)
            return residual
        return lax.map(one, (kernel, vis) + tuple(rest_args))

    rest = (batch.taper1d, batch.pixel_size, batch.mid_w, batch.uv,
            batch.sub_uv, batch.w_plane, batch.anchor, batch.valid,
            batch.weights)
    jax.block_until_ready(step(batch.kernel, batch.vis, *rest))  # compile

    start = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(step(batch.kernel, batch.vis, *rest))
    elapsed = (time.perf_counter() - start) / iters

    mvis_per_s = num_vis / elapsed / 1e6
    ggaps = num_vis * cfg.kernel_width ** 2 * cfg.num_pols / elapsed / 1e9

    return {
        "metric": "Mvis_gridded_per_sec_per_chip",
        "value": round(mvis_per_s, 3),
        "unit": "Mvis/s",
        "vs_baseline": round(ggaps / 1.0, 3),
        "ggaps": round(ggaps, 3),
        "elapsed_s": round(elapsed, 4),
        "num_vis": num_vis,
        "num_channels": num_channels,
        "pixels": cfg.pixels,
        "kernel_width": cfg.kernel_width,
        "w_slices": cfg.w_slices,
        "device": device_info(),
    }


def device_info() -> dict:
    """JAX's platform, device kind and count, and the card's name and
    power limit as nvidia-smi reports them."""
    dev = jax.devices()[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count(), "nvidia_smi": smi}


def _production_bench() -> dict:
    """The accelerator headline: the production 4-W-slice shape.

    chunks_per_slice must hold the fragmented 512k-vis slice (~5k
    occupied chunks at this UV spread); the round-4 value of 4096
    silently thinned the workload to 262k vis/slice via
    make_example_batch's fragmentation fallback."""
    from katsdpimager_tpu.parallel.multichannel import MultiChannelConfig

    cfg = MultiChannelConfig(
        pixels=4096, num_pols=1, kernel_width=60, oversample=8,
        w_planes=32, w_slices=4, chunks_per_slice=8192, chunk_size=256,
        rv=64, ru=64, minor_cycles=0, weight_type="natural")
    return run_step_bench(cfg, num_channels=8, vis_per_slice=1 << 19)


def main():
    enable_compilation_cache()
    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py: needs an NVIDIA GPU; JAX's platform is "
                 f"{platform!r}")
    print(json.dumps(_production_bench()))


if __name__ == "__main__":
    main()
