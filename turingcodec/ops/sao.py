"""Device (XLA) SAO filter twin of decode/sao.py.

Dense formulation: instead of the numpy reference's per-CTB loop, the
whole plane is filtered in one dense pass — per-CTB parameter maps
(type/class/offsets) are upsampled to pixel resolution with jnp.repeat,
the four edge-class variants are computed with whole-plane rolls and
selected per pixel, and every mask (picture border, slice/tile neighbour
rules, PCM/transquant-bypass skips, per-slice enables) is elementwise.
All work is element-wise; there is no gather with data-dependent indices.

Bit-exact with decode/sao.py (tests/test_device_sao.py); reference:
turing/sao.h:29-34, sao.cpp.
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

# eoClass -> neighbour a offset (dy, dx); b is always the negation
_EO_A = ((0, -1), (-1, 0), (-1, -1), (-1, 1))
_REMAP = jnp.asarray([1, 2, 0, 3, 4], jnp.int32)


def _up(m, fy, fx, h, w):
    """Upsample a per-CTB (or per-4x4) map to pixel resolution and crop."""
    return jnp.repeat(jnp.repeat(m, fy, axis=0), fx, axis=1)[:h, :w]


@partial(jax.jit, static_argnums=(1, 2, 3))
def _sao_plane(src, ctb, bd, sub, sao_type, sao_class, sao_off,
               slice_up, tile_up, enable_s, across_s, across_tiles,
               skip_up):
    """One plane. src (h, w); sao_* are per-CTB maps; *_up are pixel-res
    int maps; enable_s/across_s index per slice."""
    h, w = src.shape
    max_val = (1 << bd) - 1
    p = src.astype(jnp.int32)

    t_up = _up(sao_type, ctb, ctb, h, w)
    cls_up = _up(sao_class, ctb, ctb, h, w)
    offs_up = [_up(sao_off[:, :, k], ctb, ctb, h, w) for k in range(4)]

    # ---- band offset ---------------------------------------------------
    shift = bd - 5
    band_of = p >> shift
    idx = (band_of - cls_up) & 31
    band_res = p
    for k in range(4):
        band_res = jnp.where(idx == k, p + offs_up[k], band_res)
    band_res = jnp.clip(band_res, 0, max_val)

    # ---- edge offset: all four classes, then per-pixel select ----------
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    cur_slice = slice_up
    cur_tile = tile_up
    edge_res = p
    for eo, (ady, adx) in enumerate(_EO_A):
        a = jnp.roll(p, (-ady, -adx), axis=(0, 1))
        b = jnp.roll(p, (ady, adx), axis=(0, 1))
        inb = ((ys + ady >= 0) & (ys + ady < h) & (xs + adx >= 0)
               & (xs + adx < w)
               & (ys - ady >= 0) & (ys - ady < h) & (xs - adx >= 0)
               & (xs - adx < w))
        # slice/tile neighbour usability (both directions)
        nb_sl_a = jnp.roll(cur_slice, (-ady, -adx), axis=(0, 1))
        nb_sl_b = jnp.roll(cur_slice, (ady, adx), axis=(0, 1))
        nb_tl_a = jnp.roll(cur_tile, (-ady, -adx), axis=(0, 1))
        nb_tl_b = jnp.roll(cur_tile, (ady, adx), axis=(0, 1))
        allowed = jnp.where(cur_slice >= 0,
                            across_s[jnp.clip(cur_slice, 0, None)], True)
        ok = ((cur_slice == nb_sl_a) | allowed) \
            & ((cur_slice == nb_sl_b) | allowed)
        ok &= jnp.where(across_tiles, True,
                        (cur_tile == nb_tl_a) & (cur_tile == nb_tl_b))
        valid = inb & ok
        sign_a = jnp.sign(p - a)
        sign_b = jnp.sign(p - b)
        eidx = _REMAP[2 + sign_a + sign_b]
        off = jnp.zeros_like(p)
        for k in range(4):
            off = jnp.where(eidx == k + 1, offs_up[k], off)
        res = jnp.where(valid, jnp.clip(p + off, 0, max_val), p)
        edge_res = jnp.where(cls_up == eo, res, edge_res)

    enabled = jnp.where(cur_slice >= 0,
                        enable_s[jnp.clip(cur_slice, 0, None)], False)
    out = jnp.where(t_up == 1, band_res,
                    jnp.where(t_up == 2, edge_res, p))
    out = jnp.where(enabled & (t_up > 0) & jnp.logical_not(skip_up), out, p)
    return out.astype(src.dtype)


def sao_picture_device(plan, geom, deblocked, pull=True):
    """Apply SAO on device to [y, cb, cr]; returns new numpy planes
    (drop-in for decode/sao.sao_picture). With pull=False the inputs may
    be device arrays and the results stay on device (no host sync) — the
    chained-pipeline mode (decode/device_pipeline.py)."""
    sps, pps = plan.sps, plan.pps
    hc, wc = sps.pic_height_in_ctbs_y, sps.pic_width_in_ctbs_y
    shs = plan.slice_headers
    n_sl = max(1, len(shs))
    across_s = jnp.asarray(
        [bool(sh.slice_loop_filter_across_slices_enabled_flag)
         for sh in shs] or [True])
    across_tiles = jnp.asarray(
        bool(pps.loop_filter_across_tiles_enabled_flag)
        or geom.num_tiles == 1)

    # 4x4-grid skip mask (PCM w/ loop filter disabled, transquant bypass)
    h4 = sps.pic_height_in_luma_samples // 4
    w4 = sps.pic_width_in_luma_samples // 4
    skip4 = np.zeros((h4, w4), bool)
    if sps.pcm_enabled_flag and sps.pcm_loop_filter_disabled_flag:
        skip4 |= np.asarray(plan.pcm_flag, bool)[:h4, :w4]
    if pps.transquant_bypass_enabled_flag:
        skip4 |= np.asarray(plan.tq_bypass, bool)[:h4, :w4]

    out = []
    n_planes = 3 if sps.chroma_array_type else 1
    for c_idx in range(len(deblocked)):
        src = deblocked[c_idx]
        if c_idx >= n_planes:
            out.append(src.copy())
            continue
        sub = 1 if c_idx == 0 else 2
        ctb = sps.ctb_size_y // sub
        bd = sps.bit_depth_y if c_idx == 0 else sps.bit_depth_c
        h, w = src.shape
        enable_s = jnp.asarray(
            [bool(sh.slice_sao_luma_flag if c_idx == 0
                  else sh.slice_sao_chroma_flag) for sh in shs] or [False])
        slice_up = _up(jnp.asarray(plan.slice_idx, jnp.int32), ctb, ctb,
                       h, w)
        tile_up = _up(jnp.asarray(geom.tile_id, jnp.int32), ctb, ctb, h, w)
        f = 4 // sub
        skip_up = _up(jnp.asarray(skip4), f, f, h, w)
        res = _sao_plane(
            jnp.asarray(src), int(ctb), int(bd), int(sub),
            jnp.asarray(plan.sao_type[:, :, c_idx], jnp.int32),
            jnp.asarray(plan.sao_class[:, :, c_idx], jnp.int32),
            jnp.asarray(plan.sao_offsets[:, :, c_idx], jnp.int32),
            slice_up, tile_up, enable_s, across_s, across_tiles, skip_up)
        out.append(np.asarray(res) if pull else res)
    del n_sl, hc, wc
    return out
