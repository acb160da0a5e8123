"""Inter prediction: fractional-sample interpolation + sample prediction
(spec 8.5.3.2) — numpy reference implementation.

Parity reference: havoc/pred_inter.cpp (8-tap luma / 4-tap chroma kernels).
The device twin lives in ops/inter.py; this version is the bit-exactness
oracle.
"""
from __future__ import annotations

import numpy as np

from turingcodec.hevc.tables import CHROMA_FILTER, LUMA_FILTER


def _gather_padded(ref: np.ndarray, x0: int, y0: int, w: int, h: int):
    """Gather a (h, w) window with edge replication (motion over borders)."""
    hh, ww = ref.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, hh - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, ww - 1)
    return ref[np.ix_(ys, xs)].astype(np.int32)


def interp_luma(ref: np.ndarray, x_int: int, y_int: int, x_frac: int,
                y_frac: int, w: int, h: int, bit_depth: int) -> np.ndarray:
    """Returns the 14-bit intermediate prediction block (spec 8.5.3.2.2.1)."""
    shift1 = bit_depth - 8
    shift2 = 6
    shift3 = 14 - bit_depth
    if x_frac == 0 and y_frac == 0:
        block = _gather_padded(ref, x_int, y_int, w, h)
        return block << shift3
    if y_frac == 0:
        win = _gather_padded(ref, x_int - 3, y_int, w + 7, h)
        f = LUMA_FILTER[x_frac]
        acc = np.zeros((h, w), np.int32)
        for k in range(8):
            acc += f[k] * win[:, k:k + w]
        return acc >> shift1
    if x_frac == 0:
        win = _gather_padded(ref, x_int, y_int - 3, w, h + 7)
        f = LUMA_FILTER[y_frac]
        acc = np.zeros((h, w), np.int32)
        for k in range(8):
            acc += f[k] * win[k:k + h, :]
        return acc >> shift1
    win = _gather_padded(ref, x_int - 3, y_int - 3, w + 7, h + 7)
    fh = LUMA_FILTER[x_frac]
    tmp = np.zeros((h + 7, w), np.int64)
    for k in range(8):
        tmp += fh[k] * win[:, k:k + w].astype(np.int64)
    tmp >>= shift1
    fv = LUMA_FILTER[y_frac]
    acc = np.zeros((h, w), np.int64)
    for k in range(8):
        acc += fv[k] * tmp[k:k + h, :]
    return (acc >> shift2).astype(np.int32)


def interp_chroma(ref: np.ndarray, x_int: int, y_int: int, x_frac: int,
                  y_frac: int, w: int, h: int, bit_depth: int) -> np.ndarray:
    """4-tap chroma interpolation, 14-bit intermediate (spec 8.5.3.2.2.2)."""
    shift1 = bit_depth - 8
    shift2 = 6
    shift3 = 14 - bit_depth
    if x_frac == 0 and y_frac == 0:
        return _gather_padded(ref, x_int, y_int, w, h) << shift3
    if y_frac == 0:
        win = _gather_padded(ref, x_int - 1, y_int, w + 3, h)
        f = CHROMA_FILTER[x_frac]
        acc = np.zeros((h, w), np.int32)
        for k in range(4):
            acc += f[k] * win[:, k:k + w]
        return acc >> shift1
    if x_frac == 0:
        win = _gather_padded(ref, x_int, y_int - 1, w, h + 3)
        f = CHROMA_FILTER[y_frac]
        acc = np.zeros((h, w), np.int32)
        for k in range(4):
            acc += f[k] * win[k:k + h, :]
        return acc >> shift1
    win = _gather_padded(ref, x_int - 1, y_int - 1, w + 3, h + 3)
    fh = CHROMA_FILTER[x_frac]
    tmp = np.zeros((h + 3, w), np.int64)
    for k in range(4):
        tmp += fh[k] * win[:, k:k + w].astype(np.int64)
    tmp >>= shift1
    fv = CHROMA_FILTER[y_frac]
    acc = np.zeros((h, w), np.int64)
    for k in range(4):
        acc += fv[k] * tmp[k:k + h, :]
    return (acc >> shift2).astype(np.int32)


def derive_wp_tables(sh, sps):
    """Explicit weighted-prediction parameters (spec 7.4.7.3 derivations).

    Returns None when the slice has no pred_weight_table, else a dict
    {"log2d_y", "log2d_c", 0: [per-ref entries], 1: [...]} where each entry is
    {"wy", "oy", "wc": [cb, cr], "oc": [cb, cr]} with offsets already scaled
    by the bit-depth shift (WpOffsetBdShift, high-precision offsets off).
    Parity reference: turing/Read.h pred_weight_table + HM weight derivation.
    """
    pwt = getattr(sh, "pred_weight_table", None)
    if not pwt:
        return None
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    ly = pwt["luma_log2_weight_denom"]
    lc = ly + pwt.get("delta_chroma_log2_weight_denom", 0)
    out = {"log2d_y": ly, "log2d_c": lc, 0: [], 1: []}
    for li, lx in ((0, "l0"), (1, "l1")):
        t = pwt.get(lx)
        if not t:
            continue
        for i, e in enumerate(t["entries"]):
            if t["luma_flags"][i]:
                wy = (1 << ly) + e["delta_luma_weight"]
                oy = e["luma_offset"] << (bd_y - 8)
            else:
                wy, oy = 1 << ly, 0
            wc, oc = [1 << lc, 1 << lc], [0, 0]
            if t["chroma_flags"][i]:
                for j, (dw, do) in enumerate(e["chroma"]):
                    wc[j] = (1 << lc) + dw
                    # spec 7.4.7.3: offset reconstructed around half-range 128
                    v = 128 + do - ((128 * wc[j]) >> lc)
                    oc[j] = max(-128, min(127, v)) << (bd_c - 8)
            out[li].append({"wy": wy, "oy": oy, "wc": wc, "oc": oc})
    return out


def weighted_combine(p0, p1, bd, log2d, w0o0, w1o1):
    """Explicit weighted sample prediction (spec 8.5.3.3.4.3).

    p0/p1: 14-bit intermediates (either may be None); (w, o) per active list.
    """
    shift1 = 14 - bd
    log2_wd = log2d + shift1
    max_val = (1 << bd) - 1
    if p0 is not None and p1 is not None:
        w0, o0 = w0o0
        w1, o1 = w1o1
        v = (p0.astype(np.int64) * w0 + p1.astype(np.int64) * w1
             + ((o0 + o1 + 1) << log2_wd)) >> (log2_wd + 1)
    else:
        p, (w, o) = (p0, w0o0) if p0 is not None else (p1, w1o1)
        if log2_wd >= 1:
            v = ((p.astype(np.int64) * w + (1 << (log2_wd - 1)))
                 >> log2_wd) + o
        else:
            v = p.astype(np.int64) * w + o
    return np.clip(v, 0, max_val).astype(np.int32)


def predict_pu(plan, dpb_lists, x0, y0, w, h, bit_depth_y, bit_depth_c,
               wp=None):
    """Predict one PU (luma + chroma) -> (pred_y, pred_cb, pred_cr) int arrays.

    Default (non-weighted) sample prediction, spec 8.5.3.2.9; explicit
    weighted prediction (spec 8.5.3.3.4.3) when `wp` (from derive_wp_tables)
    is given.
    """
    bx, by = x0 >> 2, y0 >> 2
    preds = []  # per active list: (py, pcb, pcr) 14-bit
    for lx in (0, 1):
        r = int(plan.ref_idx[lx, by, bx])
        if r < 0:
            preds.append(None)
            continue
        ref_pic = dpb_lists[lx][r]
        mvx, mvy = int(plan.mv[lx, by, bx, 0]), int(plan.mv[lx, by, bx, 1])
        ry, rcb, rcr = ref_pic.planes
        py = interp_luma(ry, x0 + (mvx >> 2), y0 + (mvy >> 2),
                         mvx & 3, mvy & 3, w, h, bit_depth_y)
        # 4:2:0 chroma: units of 1/8th chroma sample
        xc, yc = x0 >> 1, y0 >> 1
        pcb = interp_chroma(rcb, xc + (mvx >> 3), yc + (mvy >> 3),
                            mvx & 7, mvy & 7, w >> 1, h >> 1, bit_depth_c)
        pcr = interp_chroma(rcr, xc + (mvx >> 3), yc + (mvy >> 3),
                            mvx & 7, mvy & 7, w >> 1, h >> 1, bit_depth_c)
        preds.append((py, pcb, pcr))

    out = []
    for ci, bd in ((0, bit_depth_y), (1, bit_depth_c), (2, bit_depth_c)):
        p0 = preds[0][ci] if preds[0] is not None else None
        p1 = preds[1][ci] if preds[1] is not None else None
        if wp is not None:
            def _wo(lx):
                r = int(plan.ref_idx[lx, by, bx])
                if r < 0 or r >= len(wp[lx]):
                    return (1, 0)
                e = wp[lx][r]
                return ((e["wy"], e["oy"]) if ci == 0
                        else (e["wc"][ci - 1], e["oc"][ci - 1]))
            log2d = wp["log2d_y"] if ci == 0 else wp["log2d_c"]
            out.append(weighted_combine(p0, p1, bd, log2d, _wo(0), _wo(1)))
            continue
        shift = 14 - bd
        max_val = (1 << bd) - 1
        if p0 is not None and p1 is not None:
            v = (p0.astype(np.int64) + p1 + (1 << shift)) >> (shift + 1)
        else:
            p = p0 if p0 is not None else p1
            v = (p + (1 << (shift - 1))) >> shift
        out.append(np.clip(v, 0, max_val).astype(np.int32))
    return out
