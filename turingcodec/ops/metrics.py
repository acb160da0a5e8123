"""Batched distortion metrics: SAD, SSD, Hadamard SATD.

Device twins of havoc/sad.cpp, ssd.cpp, hadamard.cpp. The encoder's motion
search evaluates thousands of candidates at once: shapes are
(B, N, N) blocks or (B, C, N, N) candidate grids — the batched
replacement for havoc's 4-way multiref SAD (havoc/sad.h:104).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def sad_batch(a: jax.Array, b: jax.Array) -> jax.Array:
    """(..., H, W) int -> (...,) int32 sum of absolute differences."""
    return jnp.sum(jnp.abs(a.astype(jnp.int32) - b.astype(jnp.int32)),
                   axis=(-2, -1))


@jax.jit
def ssd_batch(a: jax.Array, b: jax.Array) -> jax.Array:
    """(..., H, W) -> (...,) uint32 sum of squared differences.

    int32 squares, uint32 accumulation: exact up to 64x64 10-bit blocks
    (64*64*1023^2 < 2^32) without int64 (JAX's default disables it).
    """
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    sq = (d * d).astype(jnp.uint32)
    return jnp.sum(sq, axis=(-2, -1), dtype=jnp.uint32)


def _hadamard_matrix(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@functools.lru_cache(maxsize=None)
def _h_mat(n):
    return _hadamard_matrix(n)


@functools.partial(jax.jit, static_argnames=("block",))
def satd_batch(a: jax.Array, b: jax.Array, block: int = 8) -> jax.Array:
    """Hadamard SATD over (..., H, W) with HxW a multiple of block.

    Matches the HM/havoc convention: for 8x8, satd = (sum|H d H| + 2) >> 2
    per block; for 4x4, (sum + 1) >> 1; summed over the partition.
    """
    h, w = a.shape[-2:]
    d = (a.astype(jnp.int32) - b.astype(jnp.int32))
    bh = h // block
    bw = w // block
    lead = d.shape[:-2]
    d = d.reshape(lead + (bh, block, bw, block))
    d = jnp.moveaxis(d, -2, -3)  # (..., bh, bw, block, block)
    m = jnp.asarray(_h_mat(block))
    t = jnp.einsum("ij,...jk,kl->...il", m, d, m,
                   preferred_element_type=jnp.int32)
    s = jnp.sum(jnp.abs(t), axis=(-2, -1))
    if block == 8:
        s = (s + 2) >> 2
    elif block == 4:
        s = (s + 1) >> 1
    return jnp.sum(s, axis=(-2, -1))


def satd_np(a: np.ndarray, b: np.ndarray, block: int = 8) -> int:
    """numpy oracle."""
    h, w = a.shape
    m = _h_mat(block).astype(np.int64)
    total = 0
    for y in range(0, h, block):
        for x in range(0, w, block):
            d = (a[y:y + block, x:x + block].astype(np.int64)
                 - b[y:y + block, x:x + block])
            t = m @ d @ m
            s = int(np.abs(t).sum())
            if block == 8:
                s = (s + 2) >> 2
            elif block == 4:
                s = (s + 1) >> 1
            total += s
    return total
