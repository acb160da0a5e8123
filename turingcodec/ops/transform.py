"""Batched HEVC transforms as JAX/XLA ops (device twins of
decode/reconstruct.py — must match bit-exactly; integer arithmetic).

Design: the hot shape is (B, N, N) — thousands of TUs of one size batched
into a single einsum pair. All arithmetic is int32 (products bounded by
32767*90*32 < 2^27, sums exact in int32); XLA generates these s32 dots
itself (cuBLAS has no s32 x s32 GEMM), and they are exact on any
backend.

Parity reference: havoc/transform.cpp (all sizes, fwd+inv), spec 8.6.4.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from turingcodec.hevc.tables import DST4, dct2_matrix


@functools.lru_cache(maxsize=None)
def _matrix(n: int, dst: bool) -> np.ndarray:
    m = DST4 if dst else dct2_matrix(n)
    return np.asarray(m, dtype=np.int32)


def _clip16(x):
    return jnp.clip(x, -32768, 32767)


@functools.partial(jax.jit, static_argnames=("bit_depth", "use_dst"))
def inverse_transform_batch(d: jax.Array, bit_depth: int = 8,
                            use_dst: bool = False) -> jax.Array:
    """(B, N, N) int32 dequantized coeffs -> (B, N, N) int32 residual.

    Bit-exact twin of decode.reconstruct.inverse_transform.
    """
    n = d.shape[-1]
    m = jnp.asarray(_matrix(n, use_dst))
    # stage 1 (columns): e[b] = M^T @ d[b]; clip; >> 7
    e = jnp.einsum("ky,bkx->byx", m, d, preferred_element_type=jnp.int32)
    g = _clip16((e + 64) >> 7)
    # stage 2 (rows): r[b] = g[b] @ M
    r = jnp.einsum("byk,kx->byx", g, m, preferred_element_type=jnp.int32)
    bd_shift = 20 - bit_depth
    r = (r + (1 << (bd_shift - 1))) >> bd_shift
    return _clip16(r)


@functools.partial(jax.jit, static_argnames=("bit_depth", "use_dst"))
def forward_transform_batch(res: jax.Array, bit_depth: int = 8,
                            use_dst: bool = False) -> jax.Array:
    """(B, N, N) int32 residual -> (B, N, N) int32 transform coefficients.

    HM-style forward transform (encoder side): two stages with shifts
    shift1 = log2(N) + bitDepth - 9, shift2 = log2(N) + 6.
    """
    n = res.shape[-1]
    log2n = int(n).bit_length() - 1
    m = jnp.asarray(_matrix(n, use_dst))
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    # stage 1: rows: t = res @ M^T  (t[b, y, i] = sum_x res[y,x] * m[i,x])
    t = jnp.einsum("byx,ix->byi", res, m, preferred_element_type=jnp.int32)
    t = (t + (1 << (shift1 - 1))) >> shift1 if shift1 > 0 else t << -shift1
    # stage 2: columns: c[b, j, i] = sum_y m[j, y] * t[b, y, i]
    c = jnp.einsum("jy,byi->bji", m, t, preferred_element_type=jnp.int32)
    c = (c + (1 << (shift2 - 1))) >> shift2
    return c


def forward_transform_np(res: np.ndarray, bit_depth: int = 8,
                         use_dst: bool = False) -> np.ndarray:
    """numpy oracle for the forward transform (single block, (N, N))."""
    n = res.shape[-1]
    log2n = int(n).bit_length() - 1
    m = _matrix(n, use_dst).astype(np.int64)
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    t = res.astype(np.int64) @ m.T
    t = (t + (1 << (shift1 - 1))) >> shift1 if shift1 > 0 else t << -shift1
    c = m @ t
    c = (c + (1 << (shift2 - 1))) >> shift2
    return c.astype(np.int32)
