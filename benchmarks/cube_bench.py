"""Cube-wave benchmark at the BASELINE 512-channel target geometry.

Runs ONE wave of the production cube pipeline (weights + PSF + 2 major
cycles with degridding + 1024 on-device minor cycles + noise estimation)
per channel at the BASELINE.md target geometry — 8k-pixel MeerKAT-64-class
image, K=60, 4 W slices — on however many GPUs are attached, and reports
seconds per channel per card.  Runs only on an NVIDIA GPU.

Usage: python benchmarks/cube_bench.py [pixels] [vis_per_slice_log2] [pols]

``pols=4`` runs the full-Stokes (IQUV) wave.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import numpy as np  # noqa: E402

from bench import device_info  # noqa: E402
from katsdpimager_tpu.compile_cache import enable_compilation_cache  # noqa: E402

from katsdpimager_tpu.parallel import cube, make_mesh  # noqa: E402
from katsdpimager_tpu.parallel.multichannel import (  # noqa: E402
    MultiChannelConfig, make_example_batch,
)


def main():
    enable_compilation_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("cube_bench: needs an NVIDIA GPU")
    pixels = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    vps = 1 << (int(sys.argv[2]) if len(sys.argv) > 2 else 19)
    pols = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    # 16k chunk capacity: at 8k pixels the synthetic UV cloud spans ~16k
    # occupied 64-px tiles, and occupied-chunk loop bounds make capacity
    # nearly free.  Full Stokes takes a tighter layout (the P=4 batch
    # payloads alone are ~5 GB at 16k capacity); KTPU_CUBE_NC overrides.
    nc_default = 16384 if pols == 1 else 10240
    geo = dict(num_pols=pols, kernel_width=60, oversample=8,
               w_planes=32, w_slices=4,
               chunks_per_slice=int(os.environ.get("KTPU_CUBE_NC",
                                                   str(nc_default))),
               chunk_size=256, rv=64, ru=64)
    clean = dict(majors=2, minor=1024, patch=257, psf_core=64,
                 border_pixels=pixels // 50, loop_gain=0.1)

    mcfg = MultiChannelConfig(pixels=pixels, minor_cycles=0, **geo)
    batch = make_example_batch(mcfg, jax.device_count(),
                               vis_per_slice=vps)
    num_vis = int(np.asarray(batch.valid).sum())

    ccfg = cube.CubeConfig(pixels=pixels, **geo, **clean)
    mesh = make_mesh(vis_shards=1)
    wave = cube.make_wave_image(mesh, ccfg)

    def run():
        return jax.block_until_ready(wave(batch))

    run()  # compile + warm
    iters = 2
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    dt = (time.perf_counter() - t0) / iters
    n_chan = batch.kernel.shape[0]
    per_channel_card = dt / n_chan * jax.device_count()
    print(json.dumps({
        "metric": "cube_wave_s_per_channel_per_card",
        "value": round(per_channel_card, 3),
        "unit": "s/channel/card",
        "channels_per_s_per_card": round(1.0 / per_channel_card, 3),
        "pixels": pixels,
        "num_pols": pols,
        "num_vis": num_vis,
        "majors": ccfg.majors,
        "minor": ccfg.minor,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
