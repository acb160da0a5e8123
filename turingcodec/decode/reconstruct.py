"""Picture reconstruction from a PicturePlan (numpy reference implementation).

This is the bit-exactness oracle for the JAX kernels in
turingcodec.ops — every op here has a device twin that must match it
exactly (integer arithmetic throughout). Parity reference: havoc/ kernels
(transform.cpp, pred_intra.cpp, pred_inter.cpp, quantize.cpp) and
turing/Decode.h reconstruction flow.
"""
from __future__ import annotations

from typing import List, Optional

import functools

import numpy as np

from turingcodec.hevc import types as T
from turingcodec.hevc.geometry import PictureGeometry
from turingcodec.hevc.tables import (
    CHROMA_FILTER,
    LEVEL_SCALE,
    LUMA_FILTER,
    DST4,
    chroma_qp_from_luma,
    dct2_matrix,
    intra_inv_angle,
    intra_pred_angle,
)
from turingcodec.decode.plan import PicturePlan


def clip3(lo, hi, v):
    return np.minimum(np.maximum(v, lo), hi)


# ---------------------------------------------------------------- dequant

def dequant_block(coeffs: np.ndarray, qp: int, bit_depth: int,
                  log2_size: int, scale_matrix: Optional[np.ndarray] = None,
                  ) -> np.ndarray:
    """Scaling process (spec 8.6.3). coeffs int, returns int32 d[x][y]."""
    bd_shift = bit_depth + log2_size - 5
    ls = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    c = coeffs.astype(np.int64)
    if scale_matrix is None:
        m = 16
        d = (c * (ls * m) + (1 << (bd_shift - 1))) >> bd_shift
    else:
        d = (c * scale_matrix.astype(np.int64) * ls
             + (1 << (bd_shift - 1))) >> bd_shift
    return clip3(-32768, 32767, d).astype(np.int32)


# ---------------------------------------------------------------- inverse transform

def inverse_transform(d: np.ndarray, bit_depth: int, use_dst: bool,
                      ) -> np.ndarray:
    """Inverse DCT/DST + final shift (spec 8.6.4). d is (N, N) int32 [y][x].
    Returns int32 residual."""
    n = d.shape[0]
    m = DST4 if use_dst else dct2_matrix(n)
    # stage 1: columns (vertical): e = M^T @ d, clip, >>7
    e = m.T.astype(np.int64) @ d.astype(np.int64)
    g = clip3(-32768, 32767, (e + 64) >> 7)
    # stage 2: rows: r = g @ M
    r = g @ m.astype(np.int64)
    bd_shift = 20 - bit_depth
    r = (r + (1 << (bd_shift - 1))) >> bd_shift
    return clip3(-32768, 32767, r).astype(np.int32)


def transform_skip_residual(d: np.ndarray, bit_depth: int) -> np.ndarray:
    """Transform-skip path (spec 8.6.4.1 v1): r = (d<<7) rounded >> (20-B)."""
    bd_shift = 20 - bit_depth
    r = ((d.astype(np.int64) << 7) + (1 << (bd_shift - 1))) >> bd_shift
    return clip3(-32768, 32767, r).astype(np.int32)


# ---------------------------------------------------------------- intra

_HVD_THRES = {8: 7, 16: 1, 32: 0}


def intra_predict(mode: int, ref_top: np.ndarray, ref_left: np.ndarray,
                  corner: int, n: int, c_idx: int, bit_depth: int,
                  disable_edge_filters: bool = False) -> np.ndarray:
    """Intra prediction (spec 8.4.4.2.4-6) from prepared (filtered) refs.

    ref_top: p[0..2N-1][-1]; ref_left: p[-1][0..2N-1]; corner: p[-1][-1].
    Returns (n, n) int32 predSamples[y][x].
    """
    max_val = (1 << bit_depth) - 1
    if mode == 0:  # planar
        x = np.arange(n)
        y = np.arange(n)
        tr = int(ref_top[n])
        bl = int(ref_left[n])
        px = ref_top[:n].astype(np.int64)
        py = ref_left[:n].astype(np.int64)
        pred = ((n - 1 - x)[None, :] * py[:, None]
                + (x + 1)[None, :] * tr
                + (n - 1 - y)[:, None] * px[None, :]
                + (y + 1)[:, None] * bl + n) >> (n.bit_length())
        return pred.astype(np.int32)
    if mode == 1:  # DC
        dc = (int(ref_top[:n].sum()) + int(ref_left[:n].sum()) + n) >> (
            n.bit_length())
        pred = np.full((n, n), dc, np.int32)
        if c_idx == 0 and n < 32 and not disable_edge_filters:
            pred[0, :] = (ref_top[:n] + 3 * dc + 2) >> 2
            pred[:, 0] = (ref_left[:n] + 3 * dc + 2) >> 2
            pred[0, 0] = (int(ref_left[0]) + 2 * dc + int(ref_top[0]) + 2) >> 2
        return pred
    # angular
    angle = intra_pred_angle(mode)
    if mode >= 18:
        main = np.zeros(3 * n + 2, np.int64)  # index offset n: ref[-n..2n+1]
        main[n] = corner
        main[n + 1:3 * n + 1] = ref_top[:2 * n]
        main[3 * n + 1] = ref_top[2 * n - 1]
        if angle < 0:
            inv = intra_inv_angle(mode)
            # extend: ref[x] for x = -1 .. (nTbS*angle)>>5
            lo = (n * angle) >> 5
            for x in range(-1, lo - 1, -1):
                idx = ((x * inv + 128) >> 8) - 1
                # idx can exceed the defined 2n refs for shallow angles on
                # small blocks; those ref[x] are never read by prediction
                main[n + x] = (corner if idx < 0
                               else ref_left[min(idx, 2 * n - 1)])
        yv = np.arange(1, n + 1)
        i_idx = (yv * angle) >> 5
        i_fact = (yv * angle) & 31
        xs = np.arange(n)
        pos = n + 1 + i_idx[:, None] + xs[None, :]
        pred = ((32 - i_fact)[:, None] * main[pos]
                + i_fact[:, None] * main[pos + 1] + 16) >> 5
        pred = pred.astype(np.int32)
        if mode == 26 and c_idx == 0 and n < 32 and not disable_edge_filters:
            col = ref_top[0] + ((ref_left[:n].astype(np.int64) - corner) >> 1)
            pred[:, 0] = clip3(0, max_val, col)
        return pred
    else:
        main = np.zeros(3 * n + 2, np.int64)
        main[n] = corner
        main[n + 1:3 * n + 1] = ref_left[:2 * n]
        main[3 * n + 1] = ref_left[2 * n - 1]
        if angle < 0:
            inv = intra_inv_angle(mode)
            lo = (n * angle) >> 5
            for x in range(-1, lo - 1, -1):
                idx = ((x * inv + 128) >> 8) - 1
                main[n + x] = (corner if idx < 0
                               else ref_top[min(idx, 2 * n - 1)])
        xv = np.arange(1, n + 1)
        i_idx = (xv * angle) >> 5
        i_fact = (xv * angle) & 31
        ys = np.arange(n)
        pos = n + 1 + i_idx[None, :] + ys[:, None]
        # note: transposed roles — iterate over x as "distance"
        pred = ((32 - i_fact)[None, :] * main[pos]
                + i_fact[None, :] * main[pos + 1] + 16) >> 5
        pred = pred.astype(np.int32)
        if mode == 10 and c_idx == 0 and n < 32 and not disable_edge_filters:
            row = ref_left[0] + ((ref_top[:n].astype(np.int64) - corner) >> 1)
            pred[0, :] = clip3(0, max_val, row)
        return pred


def filter_reference_samples(ref_top, ref_left, corner, n, mode,
                             strong_smoothing: bool, bit_depth: int):
    """Spec 8.4.4.2.3 (luma only)."""
    if mode == 1 or n == 4:
        return ref_top, ref_left, corner
    min_dist = min(abs(mode - 26), abs(mode - 10))
    if mode != 0 and min_dist <= _HVD_THRES[n]:
        return ref_top, ref_left, corner
    if (strong_smoothing and n == 32
            and abs(int(corner) + int(ref_top[2 * n - 1]) - 2 * int(ref_top[n - 1]))
            < (1 << (bit_depth - 5))
            and abs(int(corner) + int(ref_left[2 * n - 1]) - 2 * int(ref_left[n - 1]))
            < (1 << (bit_depth - 5))):
        i = np.arange(1, 63)
        ft = np.empty_like(ref_top)
        fl = np.empty_like(ref_left)
        ft[:63] = ((63 - np.arange(63)) * int(corner)
                   + (np.arange(63) + 1) * int(ref_top[63]) + 32) >> 6
        ft[63] = ref_top[63]
        fl[:63] = ((63 - np.arange(63)) * int(corner)
                   + (np.arange(63) + 1) * int(ref_left[63]) + 32) >> 6
        fl[63] = ref_left[63]
        return ft, fl, corner
    # [1 2 1] filter
    ft = np.empty_like(ref_top)
    fl = np.empty_like(ref_left)
    t = ref_top.astype(np.int64)
    l = ref_left.astype(np.int64)
    c = int(corner)
    ft[0] = (c + 2 * t[0] + t[1] + 2) >> 2
    ft[1:2 * n - 1] = (t[0:2 * n - 2] + 2 * t[1:2 * n - 1] + t[2:2 * n] + 2) >> 2
    ft[2 * n - 1] = t[2 * n - 1]
    fl[0] = (c + 2 * l[0] + l[1] + 2) >> 2
    fl[1:2 * n - 1] = (l[0:2 * n - 2] + 2 * l[1:2 * n - 1] + l[2:2 * n] + 2) >> 2
    fl[2 * n - 1] = l[2 * n - 1]
    fc = (l[0] + 2 * c + t[0] + 2) >> 2
    return ft, fl, fc


@functools.lru_cache(maxsize=None)
def _scan_templates(n):
    """(dx, dy) offsets of the 4n+1 candidate reference positions relative
    to (x0, y0), in scan order: left bottom-up, corner, top left-to-right."""
    m = 4 * n + 1
    tx = np.empty(m, np.int32)
    ty = np.empty(m, np.int32)
    tx[:2 * n + 1] = -1
    tx[2 * n + 1:] = np.arange(2 * n)
    ty[:2 * n] = 2 * n - 1 - np.arange(2 * n)
    ty[2 * n:] = -1
    return tx, ty


class ReferenceSampleBuilder:
    """Gathers + substitutes intra reference samples (spec 8.4.4.2.2),
    vectorized in one pass over the 4n+1 candidate positions."""

    def __init__(self, plan: PicturePlan, geom: PictureGeometry):
        self.plan = plan
        self.geom = geom
        sps = plan.sps
        self._w = sps.pic_width_in_luma_samples
        self._h = sps.pic_height_in_luma_samples
        self._cl2 = sps.ctb_log2_size_y
        self._multi_slice_or_tile = None  # lazily determined

    def _complex_bounds(self):
        if self._multi_slice_or_tile is None:
            plan, geom = self.plan, self.geom
            smap = plan.slice_idx
            self._multi_slice_or_tile = (
                geom.num_tiles > 1
                or (smap.size > 0 and (smap != smap.flat[0]).any())
                or bool(plan.pps.constrained_intra_pred_flag))
        return self._multi_slice_or_tile

    def build(self, recon: np.ndarray, x0: int, y0: int, n: int, c_idx: int,
              bit_depth: int):
        """Returns (ref_top[2n], ref_left[2n], corner) with substitution.

        x0/y0/n are in the plane's own sample units; availability checks use
        luma coordinates. Scan order: left bottom-up, corner, top
        left-to-right.
        """
        plan, geom = self.plan, self.geom
        sub = 1 if c_idx == 0 else 2  # 4:2:0
        xl, yl = x0 * sub, y0 * sub
        h_pic, w_pic = recon.shape
        zs = geom.zscan
        zcur = zs[yl >> 2, xl >> 2]
        m = 4 * n + 1

        # plane-space candidate coordinates in scan order (cached templates)
        tx, ty = _scan_templates(n)
        px = x0 + tx
        py = y0 + ty

        inb = (px >= 0) & (py >= 0) & (px < w_pic) & (py < h_pic)
        pxc = np.clip(px, 0, w_pic - 1)
        pyc = np.clip(py, 0, h_pic - 1)
        lxc = pxc * sub
        lyc = pyc * sub
        ok = inb & (zs[lyc >> 2, lxc >> 2] <= zcur)
        if self._complex_bounds():
            cl2 = self._cl2
            smap = plan.slice_idx
            ok &= smap[lyc >> cl2, lxc >> cl2] == smap[yl >> cl2, xl >> cl2]
            if geom.num_tiles > 1:
                ok &= (geom.tile_id[lyc >> cl2, lxc >> cl2]
                       == geom.tile_id[yl >> cl2, xl >> cl2])
            if plan.pps.constrained_intra_pred_flag:
                ok &= plan.cu_pred_mode[lyc >> 2, lxc >> 2] == 1

        vals = recon[pyc, pxc].astype(np.int32)
        if not ok.any():
            vals[:] = 1 << (bit_depth - 1)
        else:
            if not ok[0]:
                vals[0] = vals[np.argmax(ok)]
                ok[0] = True
            vals[~ok] = 0
            src_idx = np.where(ok, np.arange(m), 0)
            np.maximum.accumulate(src_idx, out=src_idx)
            vals = vals[src_idx]
        ref_left = vals[:2 * n][::-1].copy()  # p[-1][0..2n-1]
        corner = int(vals[2 * n])
        ref_top = vals[2 * n + 1:].copy()
        return ref_top, ref_left, corner
