"""Capture a device profile of the driver-bench step and print the
aggregated kernel table.

Wraps the production 4-W-slice bench workload (``bench.run_step_bench``)
in ``jax.profiler.trace`` and aggregates the captured ``.xplane.pb`` with
``profiling.parse_device_profile``, which sums the GPU's per-stream kernel
events (the analogue of the reference's --write-device-profile GPU-event
table, reference profiling.py:133-149, scripts/imager.py:89-92).  Runs
only on an NVIDIA GPU.

Usage: python scripts/device_profile_bench.py [logdir] [top_n]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from katsdpimager_tpu.compile_cache import enable_compilation_cache  # noqa: E402


def main() -> None:
    logdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "chiprun_out", "device_profile")
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 40

    enable_compilation_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("device_profile_bench: needs an NVIDIA GPU")

    from bench import device_info, run_step_bench
    from katsdpimager_tpu import profiling
    from katsdpimager_tpu.parallel.multichannel import MultiChannelConfig

    cfg = MultiChannelConfig(
        pixels=4096, num_pols=1, kernel_width=60, oversample=8,
        w_planes=32, w_slices=4, chunks_per_slice=8192, chunk_size=256,
        rv=64, ru=64, minor_cycles=0, weight_type="natural")
    # run_step_bench compiles and warms up before its timed runs, and the
    # trace covers those: a steady-state window with one warm-up inside.
    with profiling.device_trace(logdir):
        result = run_step_bench(cfg, 2, 1 << 19, iters=2)
    print(device_info(), flush=True)
    print(result, flush=True)

    totals = profiling.parse_device_profile(logdir)
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top_n]
    total = sum(totals.values())
    print(f"\ncaptured {len(totals)} kernels, total device time "
          f"{total * 1e3:.1f} ms across the traced window", flush=True)
    print(f"{'line':24s} {'kernel':56s} {'ms':>9s} {'share':>6s}")
    for (line, op), t in rows:
        print(f"{line[:24]:24s} {op[:56]:56s} {t * 1e3:9.2f} "
              f"{t / total * 100:5.1f}%", flush=True)


if __name__ == "__main__":
    main()
