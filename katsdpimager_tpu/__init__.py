"""katsdpimager_tpu: a spectral-line radio interferometric imager in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
ska-sa/katsdpimager (GPU/CUDA): visibility preprocessing and compression,
convolutional gridding with combined anti-aliasing + W-projection kernels
inside a W-stacking loop, FFT imaging, Cotton-Schwab CLEAN deconvolution,
restoring-beam fitting/convolution, primary-beam correction and FITS output —
independently per frequency channel, sharded over device meshes.  It runs
on an NVIDIA GPU (and, for tests, on the CPU).

Design notes (vs the reference architecture):

- The reference's device runtime (katsdpsigproc Operation/slot machinery,
  Mako->CUDA JIT, autotuning) is replaced by jitted pure functions over
  pytrees; XLA is the runtime and the autotuner.
- The reference's atomic scatter-add gridder (grid.mako, Romein-style) is
  replaced by a deterministic formulation: visibilities are pre-bucketed by
  (channel, w_slice), padded to static shapes, and gridded by dense
  matrix products over tile-aligned chunks (``ops/mxu_gridder.py``), with
  an XLA tap-loop scatter-add as the reference formulation.
- The reference's per-minor-cycle GPU->CPU round trip in CLEAN (clean.py:10)
  is removed: minor cycles run entirely on device in a lax.while_loop.
- Multi-device scaling (absent in the reference) is native: frequency
  channels map to a ``jax.sharding.Mesh`` axis; visibility buckets and
  W-slices can be sharded within a channel with psum image reductions.
"""

__version__ = "0.1.0"
