"""Multi-device scale-out for the EVC encoder.

All-intra (and GOP-level) encoding is embarrassingly parallel across frames:
the natural first sharding axis is frame-parallel ("gop" axis), with
tile-parallel within a frame as the second axis once tiles land (legal per
the bitstream: per-tile CABAC reset, SURVEY.md §2.4).

This module provides the meshed sub-GOP analysis: the B-frames of a RA
sub-GOP are sharded across devices on the "gop" axis and each device runs
the full per-frame fused analysis.  The devices need no topology: the
mesh is one flat axis over however many devices are given.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "gop") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


@functools.lru_cache(maxsize=8)
def meshed_subgop_analysis(mesh: Mesh, bd: int = 10, search_range: int = 16,
                           min_log2: int = 2, max_log2: int = 6):
    """Frame-parallel sharding of the PRODUCT fused analyzer
    (enc/device_analyzer._fused_impl) over the gop axis: the B-frames of a
    RA sub-GOP are analyzed one-per-device, each against its own L0/L1
    original references.  Per-frame math is the identical single-chip
    graph, so N-chip analysis == 1-chip analysis bit-for-bit and the final
    bitstream is mesh-size invariant (asserted in
    tests/test_multichip.py).

    Returns a jitted fn(y,u,v, r0y,r0u,r0v, r1y,r1u,r1v, prms, prm3) over
    batches whose leading dim is sharded on the mesh; output: packed
    per-frame int16 decision vectors, sharded the same way.  One function
    per mesh and configuration, so every encoder on that mesh reuses its
    compiled executable."""
    from ..enc.device_analyzer import _fused_impl, PAD
    axis = mesh.axis_names[0]
    fn1 = functools.partial(_fused_impl, bd=bd, R=int(search_range), pad=PAD,
                            min_log2=min_log2, max_log2=max_log2,
                            refine=True)

    def one(y, u, v, r0y, r0u, r0v, r1y, r1u, r1v, prms, prm3):
        return fn1(y, u, v, (r0y, r0u, r0v), None, (r1y, r1u, r1v), None,
                   prms, prm3)

    def per_device(*args):
        return jax.vmap(one)(*args)

    # scan carries inside the fused graph start from literals, which the
    # varying-manual-axes check misclassifies; the graph has no cross-
    # device communication, so the check is safely disabled
    sm = jax.shard_map(per_device, mesh=mesh,
                       in_specs=(P(axis),) * 11, out_specs=P(axis),
                       check_vma=False)
    return jax.jit(sm)
