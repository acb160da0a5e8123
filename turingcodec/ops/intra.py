"""Batched intra prediction: ALL 35 modes for a batch of blocks in one
device call — the encoder's SATD sweep (turing/Search.hpp:92-145) as a
single tensor op instead of 35 sequential kernel calls.

Device twin of decode/reconstruct.intra_predict (bit-exact, integer only).

Shapes: ref_top (B, 2N+1) [index 2N = one-past pad], ref_left (B, 2N+1),
corner (B,). Output (B, 35, N, N). Gathers are precomputed static index
tables per (N); the per-batch work is pure arithmetic + one take-along-axis.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from turingcodec.hevc.tables import INTRA_PRED_ANGLE, INTRA_INV_ANGLE


@functools.lru_cache(maxsize=None)
def _angular_tables(n: int):
    """Static gather tables for all 33 angular modes of size n.

    For each mode m (2..34): prediction reads main_ref[pos] and
    main_ref[pos+1] with weights (32-f, f). main_ref is laid out as
    [-n..2n+1] from either top or left depending on the mode; we build
    indices into a unified array: ext[k] for k in 0..(3n+1) where
    ext = [projected negatives..., corner, main row/col samples...].

    Returns per-mode: (is_vertical, idx (n, n), fact (n, n), neg_src_idx
    (n,) source indices used to build the negative extension).
    """
    tabs = []
    for mode in range(2, 35):
        angle = int(INTRA_PRED_ANGLE[mode - 2])
        vertical = mode >= 18
        d = np.arange(1, n + 1)
        i_idx = (d * angle) >> 5
        i_fact = (d * angle) & 31
        xs = np.arange(n)
        # position into main[] with offset n (main[n] == corner)
        pos = n + 1 + (i_idx[:, None] if vertical else i_idx[None, :]) \
            + (xs[None, :] if vertical else xs[:, None])
        fact = (i_fact[:, None] if vertical else i_fact[None, :]) \
            * np.ones((n, n), np.int32)
        # negative extension sources (into the OTHER reference array)
        neg_src = np.zeros(n + 1, np.int32)  # for main[0..n-1] = ref[-n..-1]
        if angle < 0:
            inv = int(INTRA_INV_ANGLE[mode - 11])
            for x in range(-1, ((n * angle) >> 5) - 1, -1):
                idx = ((x * inv + 128) >> 8) - 1
                neg_src[n + x] = min(max(idx, -1), 2 * n - 1)
        tabs.append((vertical, pos.astype(np.int32), fact.astype(np.int32),
                     neg_src))
    return tabs


@functools.partial(jax.jit, static_argnames=("n", "bit_depth"))
def intra_predict_all_modes(ref_top: jax.Array, ref_left: jax.Array,
                            corner: jax.Array, n: int,
                            bit_depth: int = 8) -> jax.Array:
    """(B, 2n) refs + (B,) corner -> (B, 35, n, n) predictions (unfiltered
    refs; apply reference filtering per mode on host or via the filtered
    variants below). Luma edge filters (DC/H/V) are NOT applied — the
    encoder's SATD sweep matches HM/turing behaviour which also ranks on
    unfiltered-edge predictions.
    """
    b = ref_top.shape[0]
    max_val = (1 << bit_depth) - 1
    rt = ref_top.astype(jnp.int32)
    rl = ref_left.astype(jnp.int32)
    co = corner.astype(jnp.int32)
    outs = []

    # planar
    x = jnp.arange(n)
    y = jnp.arange(n)
    tr = rt[:, n][:, None, None]
    bl = rl[:, n][:, None, None]
    px = rt[:, :n][:, None, :]
    py = rl[:, :n][:, :, None]
    log2n = int(n).bit_length() - 1
    planar = ((n - 1 - x)[None, None, :] * py
              + (x + 1)[None, None, :] * tr
              + (n - 1 - y)[None, :, None] * px
              + (y + 1)[None, :, None] * bl + n) >> (log2n + 1)
    outs.append(planar)

    # DC (no edge filter in the sweep)
    dc = (jnp.sum(rt[:, :n], axis=1) + jnp.sum(rl[:, :n], axis=1) + n) \
        >> (log2n + 1)
    outs.append(jnp.broadcast_to(dc[:, None, None], (b, n, n)))

    # angular: build per-mode extended main arrays then gather
    for (vertical, pos, fact, neg_src) in _angular_tables(n):
        main_src = rt if vertical else rl
        other = rl if vertical else rt
        # ext[k]: k in 0..3n+1; ext[n] = corner; ext[n+1..3n] = main samples;
        # ext[0..n-1] = projected negatives from `other` (or corner)
        neg = jnp.where(jnp.asarray(neg_src[:n]) < 0, co[:, None],
                        other[:, jnp.maximum(jnp.asarray(neg_src[:n]), 0)])
        ext = jnp.concatenate(
            [neg, co[:, None], main_src[:, :2 * n],
             main_src[:, 2 * n - 1:2 * n]], axis=1)
        g0 = ext[:, jnp.asarray(pos).reshape(-1)].reshape(b, n, n)
        g1 = ext[:, (jnp.asarray(pos) + 1).reshape(-1)].reshape(b, n, n)
        f = jnp.asarray(fact)[None]
        pred = ((32 - f) * g0 + f * g1 + 16) >> 5
        outs.append(pred)

    return jnp.clip(jnp.stack(outs, axis=1), 0, max_val)


def intra_predict_all_modes_np(ref_top, ref_left, corner, n, bit_depth=8):
    """numpy oracle built on the scalar decoder op."""
    from turingcodec.decode.reconstruct import intra_predict
    b = ref_top.shape[0]
    out = np.zeros((b, 35, n, n), np.int32)
    for i in range(b):
        for mode in range(35):
            out[i, mode] = intra_predict(
                mode, ref_top[i], ref_left[i], int(corner[i]), n, 1,
                bit_depth)  # c_idx 1 => no luma edge filters
    return out
