"""Device-mesh sharding for the codec's batched pixel pipeline.

The reference scales via WPP threads + concurrent frames (SURVEY.md §2.7);
this design shards (frames, CTU-rows) over a 2D device mesh:

- axis "frame": data/pipeline parallelism across pictures of a GOP
  (the `--concurrent-frames` analogue, TaskEncodeInput.cpp throttle)
- axis "row": wavefront parallelism across CTU rows within a picture
  (the TaskEncodeSubstream analogue) — rows become a sharded batch
  dimension of diagonal-wave CTU tensors

Cross-device reductions (rate totals, distortion sums) are collectives
that XLA inserts for jnp.sum over sharded axes under jit; halo exchange for inter prediction
uses jax.lax collectives in later rounds.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_frames: int, n_rows: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_frames * n_rows, "not enough devices"
    dev = np.asarray(devices[: n_frames * n_rows]).reshape(n_frames, n_rows)
    return Mesh(dev, ("frame", "row"))


def analysis_step(ctus: jax.Array, preds: jax.Array, qp: jax.Array):
    """One batched encoder analysis step over sharded CTU tensors.

    ctus, preds: (F, R, B, 32, 32) int32 source blocks and predictions,
    sharded over (frame, row). Computes residual -> forward DCT -> quant ->
    rate proxy + SSD distortion, returning per-shard costs and the global
    (collective-reduced) totals.
    """
    from turingcodec.ops.transform import forward_transform_batch
    from turingcodec.ops.quant import quant_batch

    f, r, b, n, _ = ctus.shape
    res = (ctus - preds).reshape(f * r * b, n, n)
    coeffs = forward_transform_batch(res, 8, False)
    qps = jnp.broadcast_to(qp.reshape(()), (f * r * b,))
    rounding = jnp.full((f * r * b,), 171 << 6, jnp.int32)
    levels = quant_batch(coeffs, qps, 8, 5, rounding)
    # rate proxy: nonzero count + log2-ish magnitude; distortion: SSD of
    # dequantized reconstruction error proxy (levels==0 coefficients)
    rate = jnp.sum(jnp.abs(levels) > 0, axis=(1, 2)) + jnp.sum(
        jnp.abs(levels), axis=(1, 2))
    cf = coeffs.astype(jnp.float32)
    dist = jnp.sum(jnp.where(levels == 0, cf * cf, 0.0),
                   axis=(1, 2)).astype(jnp.int32)
    rate = rate.reshape(f, r, b)
    dist = dist.reshape(f, r, b)
    # global totals reduce across the mesh (XLA inserts the collectives)
    total_rate = jnp.sum(rate)
    total_dist = jnp.sum(dist)
    return rate, dist, total_rate, total_dist


def sharded_analysis(mesh: Mesh):
    """jit the analysis step with (frame, row)-sharded inputs."""
    in_shard = NamedSharding(mesh, P("frame", "row"))
    rep = NamedSharding(mesh, P())
    fn = jax.jit(
        analysis_step,
        in_shardings=(in_shard, in_shard, rep),
        out_shardings=(in_shard, in_shard, rep, rep),
    )
    return fn
