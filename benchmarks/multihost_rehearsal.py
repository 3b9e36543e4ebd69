"""Multi-process ``jax.distributed`` rehearsal of a multi-host mesh, on
the CPU only.

A multi-host layout puts the ``chan`` mesh axis across hosts — zero
steady-state communication — and keeps the psum-heavy ``vis`` axis within
a host.  This script rehearses the full multi-controller code path with
several processes on the CPU (each process on the card would reserve
most of its memory, so it never runs there): ``jax.distributed.initialize``,
per-process channel data assembled into globally-sharded arrays with
``jax.make_array_from_process_local_data``, one shard_mapped imaging step
over the global ("chan", "vis") mesh, and per-process output-shard
fetches.

Launch one process per "host" (the test harness does this):

    python benchmarks/multihost_rehearsal.py --coordinator localhost:9876 \
        --num-processes 2 --process-id 0 --local-devices 4 &
    python benchmarks/multihost_rehearsal.py --coordinator localhost:9876 \
        --num-processes 2 --process-id 1 --local-devices 4

Each process prints ONE JSON line with timing and its local checksum.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 (omit for 1 process)")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--local-devices", type=int, default=4)
    parser.add_argument("--vis-shards", type=int, default=1)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--pixels", type=int, default=64)
    parser.add_argument("--kernel-width", type=int, default=8)
    parser.add_argument("--minor", type=int, default=20)
    args = parser.parse_args(argv)

    # Force the virtual CPU topology before JAX initialises its backends.
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{args.local_devices}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from katsdpimager_tpu.parallel import make_mesh
    from katsdpimager_tpu.parallel.mesh import initialize_distributed
    from katsdpimager_tpu.parallel.multichannel import (
        MultiChannelConfig, make_example_batch, make_global_batch,
        make_imaging_step,
    )

    if args.num_processes > 1:
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)
    expected = args.local_devices * args.num_processes
    if jax.device_count() != expected:
        raise RuntimeError(
            f"global device count {jax.device_count()} != {expected}")

    mesh = make_mesh(vis_shards=args.vis_shards)
    chan_local = args.local_devices // args.vis_shards

    cfg = MultiChannelConfig(
        pixels=args.pixels, num_pols=1, kernel_width=args.kernel_width,
        oversample=8, w_planes=2, w_slices=2, chunks_per_slice=8,
        chunk_size=32, rv=32, ru=32, minor_cycles=args.minor, patch=17)
    # Distinct data per process: the chan axis is data-parallel.
    local = make_example_batch(cfg, chan_local, seed=args.process_id + 1)
    batch = make_global_batch(mesh, local)
    step = make_imaging_step(mesh, cfg)

    residual, model = jax.block_until_ready(step(batch))  # compile
    t0 = time.perf_counter()
    for _ in range(args.iters):
        residual, model = step(batch)
    jax.block_until_ready((residual, model))
    dt = (time.perf_counter() - t0) / args.iters

    local_sum = sum(float(np.abs(np.asarray(s.data)).sum())
                    for s in residual.addressable_shards)
    chan_global = mesh.shape["chan"]
    print(json.dumps({
        "process": args.process_id,
        "num_processes": args.num_processes,
        "global_devices": jax.device_count(),
        "channels_global": chan_global,
        "sec_per_step": round(dt, 4),
        "channels_per_sec": round(chan_global / dt, 2),
        "local_checksum": local_sum,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
