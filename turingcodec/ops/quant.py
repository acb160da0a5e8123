"""Batched (de)quantization ops (spec 8.6.3; havoc/quantize.cpp parity).

All shapes (B, N, N) int32; scalar qp per batch element supported via
broadcast arrays so one jit covers mixed-QP batches.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from turingcodec.hevc.tables import LEVEL_SCALE, QUANT_SCALES

def _select6(idx: jax.Array, values) -> jax.Array:
    """6-way select chain standing in for a 6-entry table gather: exact,
    element-wise, and fused by XLA into its consumers."""
    out = jnp.full_like(idx, int(values[5]))
    for k in range(4, -1, -1):
        out = jnp.where(idx == k, int(values[k]), out)
    return out.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("bit_depth", "log2_size"))
def dequant_batch(coeffs: jax.Array, qp: jax.Array, bit_depth: int,
                  log2_size: int) -> jax.Array:
    """(B, N, N) levels + (B,) qp -> (B, N, N) int32 dequantized (flat list).

    int32-exact restructuring (JAX runs without int64 by default): fold qp//6 into the
    shift instead of the scale — algebraically identical to the oracle's
    int64 form because the rounding constant scales with the shift.
    """
    bd_shift = bit_depth + log2_size - 5
    ls16 = _select6(qp % 6, LEVEL_SCALE) * 16   # <= 1152: fits int32
    shift = bd_shift - (qp // 6)            # (B,), may go negative
    sh_pos = jnp.maximum(shift, 0)
    sh_neg = jnp.maximum(-shift, 0)
    rnd = jnp.where(shift > 0, 1 << jnp.maximum(shift - 1, 0), 0)
    p = coeffs.astype(jnp.int32) * ls16[:, None, None]
    d = ((p + rnd[:, None, None]) >> sh_pos[:, None, None]) \
        << sh_neg[:, None, None]
    return jnp.clip(d, -32768, 32767).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("bit_depth", "log2_size"))
def quant_batch(coeffs: jax.Array, qp: jax.Array, bit_depth: int,
                log2_size: int, rounding_num: jax.Array) -> jax.Array:
    """Forward quantization (HM-style): (B, N, N) transform coeffs -> levels.

    level = sign(c) * ((|c| * f[qp%6] + round) >> shift)
    shift = 29 - 6 - bitDepth - log2 + qp//6 ... expressed per HM:
    qShift = 14 + qp//6 + TransformShift, TransformShift = 15 - bitDepth - log2.
    rounding_num: (B,) additive rounding (lambda-dependent; 1/3 intra, 1/6
    inter of (1<<qShift) typically), passed in by the encoder.
    """
    t_shift = 15 - bit_depth - log2_size
    q_shift = 14 + (qp // 6) + t_shift
    f = _select6(qp % 6, QUANT_SCALES)
    a = jnp.abs(coeffs).astype(jnp.int32)
    # |coeff| <= 2^15, f <= 26214: product < 2^30, +rounding stays in int32
    level = (a * f[:, None, None]
             + rounding_num[:, None, None]) >> q_shift[:, None, None]
    level = jnp.clip(level, 0, 32767)
    return jnp.where(coeffs < 0, -level, level).astype(jnp.int32)


def quant_np(coeffs, qp, bit_depth, log2_size, rounding_num):
    """numpy oracle of quant_batch for one scalar qp and rounding."""
    q_shift = 14 + qp // 6 + 15 - bit_depth - log2_size
    a = np.abs(coeffs.astype(np.int64))
    level = np.minimum((a * int(QUANT_SCALES[qp % 6]) + rounding_num)
                       >> q_shift, 32767)
    return np.where(coeffs < 0, -level, level).astype(np.int32)


def dequant_np(coeffs, qp, bit_depth, log2_size):
    """numpy oracle (flat scaling matrix)."""
    bd_shift = bit_depth + log2_size - 5
    ls = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    d = (coeffs.astype(np.int64) * ls * 16 + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)
