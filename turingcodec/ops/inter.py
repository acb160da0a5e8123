"""Batched fractional-sample interpolation (device twin of
decode/inter_pred.py; havoc/pred_inter.cpp parity).

The encoder's sub-pel refinement evaluates many candidate fractional MVs at
once: interp_luma_batch takes a batch of pre-gathered padded windows and the
per-candidate fractional positions and produces all predictions in one call.
All 16 quarter-pel phase pairs are computed via one grouped convolution-like
einsum; the per-candidate phase selects the right plane (gathers over a
16-way axis are cheap; the arithmetic is shared).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from turingcodec.hevc.tables import CHROMA_FILTER, LUMA_FILTER


@functools.partial(jax.jit, static_argnames=("w", "h", "bit_depth"))
def interp_luma_all_phases(win: jax.Array, w: int, h: int,
                           bit_depth: int = 8) -> jax.Array:
    """(B, h+7, w+7) padded windows -> (B, 4, 4, h, w) 14-bit predictions
    for every (yfrac, xfrac) quarter-pel phase.

    Bit-exact with decode.inter_pred.interp_luma for each phase.
    """
    shift1 = bit_depth - 8
    shift2 = 6
    shift3 = 14 - bit_depth
    win = win.astype(jnp.int32)
    f = jnp.asarray(np.asarray(LUMA_FILTER))  # (4 phases, 8 taps)

    # horizontal stage for all 4 x-phases: htmp[b, px, y, x]
    cols = jnp.stack([win[:, :, k:k + w] for k in range(8)], axis=-1)
    htmp = jnp.einsum("byxk,pk->bpyx", cols, f,
                      preferred_element_type=jnp.int32)
    htmp = htmp >> shift1                      # (B, 4, h+7, w)
    # phase x=0 must be the unshifted full-pel row scaled later; the filter
    # row [0,0,0,64,0,0,0,0] already reproduces ref<<6 ... (64*ref)>>shift1
    # which equals the spec's intermediate for fractional-y paths.

    # vertical stage for all 4 y-phases applied to every x-phase
    rows = jnp.stack([htmp[:, :, k:k + h, :] for k in range(8)], axis=-1)
    out = jnp.einsum("bpyxk,qk->bqpyx", rows, f,
                     preferred_element_type=jnp.int32)
    out = out >> shift2                        # (B, 4y, 4x, h, w)

    # exact-phase corrections: the all-phase pipeline equals the spec only
    # for (yfrac>0, xfrac>0). Patch the pure cases:
    # (0, 0): ref << shift3 ; (0, x>0): H only >> shift1 ; (y>0, 0): V only.
    center = win[:, 3:3 + h, 3:3 + w]
    h_only = htmp[:, :, 3:3 + h, :]            # (B, 4x, h, w)
    vcols = jnp.stack([win[:, k:k + h, 3:3 + w] for k in range(8)], axis=-1)
    v_only = jnp.einsum("byxk,qk->bqyx", vcols, f,
                        preferred_element_type=jnp.int32) >> shift1
    out = out.at[:, 0, :, :, :].set(h_only)
    out = out.at[:, :, 0, :, :].set(v_only)
    out = out.at[:, 0, 0, :, :].set(center << shift3)
    return out


@functools.partial(jax.jit, static_argnames=("bs", "taps", "bit_depth"))
def mc_block_grid(refs: jax.Array, ref_sel: jax.Array, xi: jax.Array,
                  yi: jax.Array, xf: jax.Array, yf: jax.Array, bs: int,
                  taps: int, bit_depth: int = 8) -> jax.Array:
    """Per-block single-phase MC over stacked reference planes.

    refs: (R, H, W) int; per-block (B,) arrays: ref_sel index into R,
    xi/yi integer top-left sample position (mv integer part applied,
    clamped gather — spec edge extension), xf/yf fractional phase.
    Returns (B, bs, bs) 14-bit intermediate predictions; bit-exact with
    decode.inter_pred.interp_luma/interp_chroma per block.

    This is the decoder's device MC: every 4x4 luma (2x2 chroma) min-block
    carries its PU's motion, so a whole picture is one uniform batch —
    the batched replacement for per-PU scalar interpolation.
    """
    shift1 = bit_depth - 8
    shift2 = 6
    shift3 = 14 - bit_depth
    off = taps // 2 - 1
    span = bs + taps - 1
    _, hh, ww = refs.shape
    filt = jnp.asarray(np.asarray(LUMA_FILTER if taps == 8
                                  else CHROMA_FILTER, np.int32))
    ys = jnp.clip(yi[:, None] - off + jnp.arange(span)[None, :], 0, hh - 1)
    xs = jnp.clip(xi[:, None] - off + jnp.arange(span)[None, :], 0, ww - 1)
    win = refs[ref_sel[:, None, None], ys[:, :, None],
               xs[:, None, :]].astype(jnp.int32)        # (B, span, span)
    fh = filt[xf]                                        # (B, taps)
    fv = filt[yf]
    cols = jnp.stack([win[:, :, k:k + bs] for k in range(taps)], axis=-1)
    htmp = jnp.einsum("byxk,bk->byx", cols, fh,
                      preferred_element_type=jnp.int32) >> shift1
    rows = jnp.stack([htmp[:, k:k + bs, :] for k in range(taps)], axis=-1)
    out2d = jnp.einsum("byxk,bk->byx", rows, fv,
                       preferred_element_type=jnp.int32) >> shift2
    h_only = htmp[:, off:off + bs, :]
    vcols = jnp.stack([win[:, k:k + bs, off:off + bs] for k in range(taps)],
                      axis=-1)
    v_only = jnp.einsum("byxk,bk->byx", vcols, fv,
                        preferred_element_type=jnp.int32) >> shift1
    center = win[:, off:off + bs, off:off + bs] << shift3
    zx = (xf == 0)[:, None, None]
    zy = (yf == 0)[:, None, None]
    return jnp.where(zx & zy, center,
                     jnp.where(zy, h_only, jnp.where(zx, v_only, out2d)))


def interp_luma_all_phases_np(win: np.ndarray, w: int, h: int,
                              bit_depth: int = 8) -> np.ndarray:
    """numpy oracle via the scalar decoder op on an inner window."""
    from turingcodec.decode.inter_pred import interp_luma
    b = win.shape[0]
    out = np.zeros((b, 4, 4, h, w), np.int64)
    for i in range(b):
        # emulate a reference picture where the window sits at (3, 3)
        ref = win[i]
        for fy in range(4):
            for fx in range(4):
                out[i, fy, fx] = interp_luma(ref, 3, 3, fx, fy, w, h,
                                             bit_depth)
    return out
