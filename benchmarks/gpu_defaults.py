"""Time the variants behind the GPU's platform defaults on the attached
NVIDIA GPU.

    python benchmarks/gpu_defaults.py [out.json]

At the step shape of ``bench.py`` (4096 pixels, P=1, K=60, oversample 8,
32 W planes, 2M visibilities per channel over 4 W slices, so 512k per
slice; tiles of 64, chunks of 256) it times, per W slice:

1. grid and degrid with each band assembly of ``ops/mxu_gridder.py``, and
   with the scatter formulation of ``ops/gridder.py`` (XLA lowers its
   duplicate-index adds to atomics on the GPU — the reference's own
   approach), each beside its error against the float64 scatter oracle
   (gate 5e-7, :mod:`katsdpimager_tpu.accuracy`);
2. the winner and the runner-up among the assemblies that meet the gate at
   8192 pixels, with the device memory XLA plans for each call;
3. the per-channel ``MxuGridder`` in its dense and scan modes;
4. one cube slice body (grid, FFT and W correction into the dirty image;
   model FFT and degrid) through the float32 "parts" planes and through
   the complex grid;
5. the ``bench.py`` step for one channel with its 4 W slices unrolled
   into straight-line code and as a ``lax.scan``, compile time beside
   step time.

Each time is the median of 3 runs after a warm-up, each ended by
``block_until_ready``.  Results print one per line and go to ``out.json``
(default ``chiprun_out/gpu_defaults.json``).  Fails without a GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from katsdpimager_tpu import accuracy  # noqa: E402
from katsdpimager_tpu.compile_cache import enable_compilation_cache  # noqa: E402
from katsdpimager_tpu.ops import fourier, gridder, mxu_gridder  # noqa: E402

ASSEMBLIES = ("fft", "tapdict", "tapsmm", "matmul", "joint", "onehot")
TS, MC = 64, 256
VIS_PER_SLICE = 1 << 19


def timed(fn, *args, repeats: int = 3) -> dict:
    """Compile + warm-up time, then the median of ``repeats`` runs."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - t0)
    return {"first_s": first, "median_s": statistics.median(runs),
            "runs_s": runs}


def memory_bytes(fn, *args) -> int:
    """Device memory XLA plans for one call: arguments, outputs, temps."""
    m = fn.lower(*args).compile().memory_analysis()
    return int(m.argument_size_in_bytes + m.output_size_in_bytes
               + m.temp_size_in_bytes)


def device_arrays(work, p):
    return dict(kernel=jnp.asarray(work.kernel), uv=jnp.asarray(p.uv),
                sub=jnp.asarray(p.sub_uv), wp=jnp.asarray(p.w_plane),
                vis=jnp.asarray(p.vis), anchor=jnp.asarray(p.anchor),
                valid=jnp.asarray(p.valid),
                wt=jnp.ones(p.vis.shape, jnp.float32))


def make_grid_fn(pixels, assembly):
    @jax.jit
    def fn(kernel, uv, sub, wp, vis, anchor, valid):
        ext = mxu_gridder.dense_pad_size(pixels, TS)
        gpad = jnp.zeros((vis.shape[-1], ext, ext), jnp.complex64)
        gpad = mxu_gridder.grid_chunks_dense_impl(
            gpad, kernel, None, uv, sub, wp, vis, anchor, valid, None,
            mxu_gridder.occupied_chunks(valid), pixels=pixels, ts=TS,
            assembly=assembly)
        return gpad[:, :pixels, :pixels]
    return fn


def make_degrid_fn(pixels, assembly):
    @jax.jit
    def fn(grid, kernel, uv, sub, wp, wt, vis, anchor, valid):
        ext = mxu_gridder.dense_pad_size(pixels, TS)
        gpad = jnp.pad(grid, ((0, 0), (0, ext - pixels), (0, ext - pixels)))
        return mxu_gridder.degrid_chunks_impl(
            gpad, kernel, uv, sub, wp, wt, vis, anchor, valid,
            mxu_gridder.occupied_chunks(valid), pixels=pixels, rv=TS, ru=TS,
            assembly=assembly)
    return fn


def assemblies(work, results):
    p = accuracy.plan(work, TS, MC)
    d = device_arrays(work, p)
    grid_args = (d["kernel"], d["uv"], d["sub"], d["wp"], d["vis"],
                 d["anchor"], d["valid"])
    with jax.enable_x64(True):
        oracle = accuracy.grid_f64(work)
    model = None
    out = {}
    for assembly in ASSEMBLIES:
        gfn = make_grid_fn(work.pixels, assembly)
        g = timed(gfn, *grid_args)
        grid = gfn(*grid_args)
        with jax.enable_x64(True):
            g["error"] = float(accuracy._max_rel(grid, oracle))
        if model is None:
            model = grid
        dfn = make_degrid_fn(work.pixels, assembly)
        dg = timed(dfn, model, d["kernel"], d["uv"], d["sub"], d["wp"],
                   d["wt"], d["vis"], d["anchor"], d["valid"])
        out[assembly] = {"grid": g, "degrid": dg}
        emit(results, f"assembly {assembly} N={work.pixels}", out[assembly])

    n = len(work.uv)
    sargs = (jnp.asarray(work.uv), jnp.asarray(work.sub_uv),
             jnp.asarray(work.w_plane))
    scatter = jax.jit(lambda kernel, wg, uv, sub, wp, vis: gridder.grid_vis_impl(
        jnp.zeros(wg.shape, jnp.complex64), kernel, wg, uv, sub, wp, vis,
        pixels=work.pixels))
    wg = jnp.ones((work.num_pols, work.pixels, work.pixels), jnp.float32)
    vis = jnp.asarray(work.vis)
    g = timed(scatter, d["kernel"], wg, *sargs, vis)
    with jax.enable_x64(True):
        g["error"] = float(accuracy._max_rel(
            scatter(d["kernel"], wg, *sargs, vis), oracle))
    sdegrid = jax.jit(lambda grid, kernel, uv, sub, wp, wt, vis:
                      gridder.degrid_vis_impl(grid, kernel, uv, sub, wp, wt,
                                              vis, pixels=work.pixels))
    dg = timed(sdegrid, model, d["kernel"], *sargs,
               jnp.ones((n, work.num_pols), jnp.float32), vis)
    out["scatter"] = {"grid": g, "degrid": dg}
    emit(results, f"assembly scatter N={work.pixels}", out["scatter"])
    return out, p


def large(work, results, ranked):
    p = accuracy.plan(work, TS, MC)
    d = device_arrays(work, p)
    grid_args = (d["kernel"], d["uv"], d["sub"], d["wp"], d["vis"],
                 d["anchor"], d["valid"])
    for assembly in ranked[:2]:
        gfn = make_grid_fn(work.pixels, assembly)
        g = timed(gfn, *grid_args)
        g["memory_bytes"] = memory_bytes(gfn, *grid_args)
        model = gfn(*grid_args)
        dfn = make_degrid_fn(work.pixels, assembly)
        dargs = (model, d["kernel"], d["uv"], d["sub"], d["wp"], d["wt"],
                 d["vis"], d["anchor"], d["valid"])
        dg = timed(dfn, *dargs)
        dg["memory_bytes"] = memory_bytes(dfn, *dargs)
        emit(results, f"assembly {assembly} N={work.pixels}",
             {"grid": g, "degrid": dg})


def modes(work, results):
    """Per-channel MxuGridder: dense (tile-aligned, parallel bands) against
    scan (bounding-box chunks, sequential windows); both degrid with the
    platform's default assembly."""
    N, P = work.pixels, work.num_pols
    weights = np.ones(work.vis.shape, np.float32)
    kernel = jnp.asarray(work.kernel)
    wg = jnp.ones((P, N, N), jnp.float32)
    for mode in ("dense", "scan"):
        g = mxu_gridder.MxuGridder(pixels=N, kernel_width=work.kernel.shape[-1],
                                   num_pols=P, rv=64, ru=64, mc=MC,
                                   mode=mode)
        plan = g.upload_plan(g.plan(work.uv, work.sub_uv, work.w_plane,
                                    work.vis, weights))
        vis_c = jnp.asarray(g.chunk_vis(plan, work.vis))
        zero = jnp.zeros((P, N, N), jnp.complex64)
        r = {"grid": timed(lambda v: g.grid(zero, kernel, wg, plan,
                                            vis_chunked=v), vis_c),
             "degrid": timed(lambda v: g.degrid(zero, kernel, plan, v),
                             vis_c)}
        emit(results, f"mode {mode} N={N}", r)


def slice_paths(work, p, results, assembly):
    """One cube slice body through the f32 parts planes and through the
    complex grid."""
    from katsdpimager_tpu.ops import wkernel

    N = work.pixels
    d = device_arrays(work, p)
    taper = jnp.asarray(wkernel.taper(N, 7.0, 8), jnp.float32)
    ps = jnp.float32(work.image_p.pixel_size)
    w = jnp.float32(3000.0)

    def body(parts):
        def fn(dirty, model, kernel, uv, sub, wp, wt, vis, anchor, valid):
            nc = mxu_gridder.occupied_chunks(valid)
            if parts:
                gr, gi = mxu_gridder.grid_chunks_parts_impl(
                    kernel, None, uv, sub, wp, vis, anchor, valid, None, nc,
                    pixels=N, ts=TS, assembly=assembly)
                dirty = fourier.grid_to_image_parts_impl(
                    gr, gi, dirty, taper, w, ps, pixels=N)
                mr, mi = fourier.image_to_grid_parts_impl(
                    model, taper, w, ps, pixels=N)
                pad = ((0, 0), (0, TS), (0, TS))
                mgrid = (jnp.pad(mr, pad), jnp.pad(mi, pad))
            else:
                ext = mxu_gridder.dense_pad_size(N, TS)
                gpad = jnp.zeros((vis.shape[-1], ext, ext), jnp.complex64)
                gpad = mxu_gridder.grid_chunks_dense_impl(
                    gpad, kernel, None, uv, sub, wp, vis, anchor, valid,
                    None, nc, pixels=N, ts=TS, assembly=assembly)
                dirty = fourier.grid_to_image_impl(
                    gpad[:, :N, :N], dirty, taper, w, ps, pixels=N)
                mgrid = jnp.pad(fourier.image_to_grid_impl(
                    model, taper, w, ps, pixels=N),
                    ((0, 0), (0, TS), (0, TS)))
            new_vis = mxu_gridder.degrid_chunks_impl(
                mgrid, kernel, uv, sub, wp, wt, vis, anchor, valid, nc,
                pixels=N, rv=TS, ru=TS, assembly=assembly)
            return dirty, new_vis
        return jax.jit(fn)

    dirty = jnp.zeros((1, N, N), jnp.float32)
    model = jnp.zeros((1, N, N), jnp.float32).at[0, N // 2, N // 2].set(1.0)
    args = (dirty, model, d["kernel"], d["uv"], d["sub"], d["wp"], d["wt"],
            d["vis"], d["anchor"], d["valid"])
    for name, parts in (("parts", True), ("complex", False)):
        r = timed(body(parts), *args)
        emit(results, f"slice {name} N={N}", {"slice": r})


def slice_loop(results):
    """The bench.py step (one channel) with the W-slice loop unrolled and
    as a scan (``parallel/slices.py`` reads KTPU_UNROLL_SLICES at trace
    time)."""
    from katsdpimager_tpu.parallel.multichannel import (
        MultiChannelConfig, make_example_batch, single_channel_step)

    cfg = MultiChannelConfig(
        pixels=4096, num_pols=1, kernel_width=60, oversample=8,
        w_planes=32, w_slices=4, chunks_per_slice=8192, chunk_size=MC,
        rv=TS, ru=TS, minor_cycles=0, weight_type="natural")
    batch = make_example_batch(cfg, 1, vis_per_slice=VIS_PER_SLICE)
    args = tuple(x[0] for x in batch)
    for unroll in ("1", "0"):
        os.environ["KTPU_UNROLL_SLICES"] = unroll
        r = timed(jax.jit(single_channel_step(cfg)), *args)
        emit(results, f"step slices unroll={unroll}", {"step": r})
    del os.environ["KTPU_UNROLL_SLICES"]


def emit(results, name, value):
    results[name] = value
    flat = {k: {kk: (round(vv, 6) if isinstance(vv, float) else vv)
                for kk, vv in v.items() if kk != "runs_s"}
            for k, v in value.items()}
    print(f"{name}: {json.dumps(flat)}", flush=True)


def main():
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"gpu_defaults: needs an NVIDIA GPU, JAX found {dev.platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    results = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                          "count": jax.device_count(), "nvidia_smi": smi,
                          "jax": jax.__version__}}
    print(json.dumps(results["device"]), flush=True)
    measure(results, accuracy.make_workload(4096, 1, VIS_PER_SLICE, seed=4),
            accuracy.make_workload(8192, 1, VIS_PER_SLICE, seed=5))
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "chiprun_out", "gpu_defaults.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def measure(results, work, work_large):
    out, p = assemblies(work, results)
    gated = sorted((a for a in ASSEMBLIES
                    if out[a]["grid"]["error"] <= accuracy.GRID_TOL),
                   key=lambda a: out[a]["grid"]["median_s"]
                   + out[a]["degrid"]["median_s"])
    results["ranked_gated_assemblies"] = gated
    print(f"ranked (grid+degrid, gate met): {gated}", flush=True)
    large(work_large, results, gated)
    slice_paths(work, p, results, gated[0])
    modes(work, results)
    slice_loop(results)


if __name__ == "__main__":
    main()
