"""Scan over the static W-slice axis, optionally unrolled.

The loop is a ``lax.scan`` by default, so compile time does not grow with
the slice count: the 8k MeerKAT-64 cube at the default ``--w-step`` has 39
W slices, and each pass over them (PSF, major cycles, degrid) unrolled
into straight-line code multiplies the program by that count.
``KTPU_UNROLL_SLICES=1`` unrolls the loop instead, which lets XLA fuse
across slice bodies at the price of compile time.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp


def scan_slices(body, init, xs):
    """``lax.scan(body, init, xs)``, or its Python unrolling under
    ``KTPU_UNROLL_SLICES=1``.

    Same contract as ``lax.scan`` for tuple-of-arrays ``xs`` with equal
    leading (slice) axes; ``body`` returns ``(carry, y)`` where ``y`` may
    be None (pure carry) or an array pytree (stacked on return).
    """
    if os.environ.get("KTPU_UNROLL_SLICES", "0") != "1":
        return jax.lax.scan(body, init, xs)
    leaves = jax.tree_util.tree_leaves(xs)
    num = leaves[0].shape[0]
    carry = init
    ys = []
    for s in range(num):
        carry, y = body(carry, jax.tree_util.tree_map(lambda a: a[s], xs))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    stacked = jax.tree_util.tree_map(lambda *vs: jnp.stack(vs), *ys)
    return carry, stacked
