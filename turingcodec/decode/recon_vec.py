"""Batched inter reconstruction: motion compensation for every inter PU and
residual add for every inter TU of a picture in grouped vector ops.

Inter prediction reads only reference pictures, so all inter CUs can be
reconstructed up front in one pass regardless of decode order; intra CUs
then run in decode order (their neighbour availability is geometric, so the
early inter pixels are invisible to them unless legitimately available).
This mirrors the device pipeline: MC and IDCT as batched ops, serial work
only where the spec demands it.

Bit-exact with the scalar path (decode/inter_pred.py + picture_recon.py).
"""
from __future__ import annotations

import numpy as np

from turingcodec.hevc import types as T
from turingcodec.hevc.tables import CHROMA_FILTER, LUMA_FILTER
from turingcodec.decode.reconstruct import dequant_block, inverse_transform


def _pu_geometry(cu, part_mode):
    x0, y0 = cu.x0, cu.y0
    s = 1 << cu.log2_size
    h = s >> 1
    q = s >> 2
    return {
        T.PART_2Nx2N: [(x0, y0, s, s)],
        T.PART_2NxN: [(x0, y0, s, h), (x0, y0 + h, s, h)],
        T.PART_Nx2N: [(x0, y0, h, s), (x0 + h, y0, h, s)],
        T.PART_NxN: [(x0, y0, h, h), (x0 + h, y0, h, h),
                     (x0, y0 + h, h, h), (x0 + h, y0 + h, h, h)],
        T.PART_2NxnU: [(x0, y0, s, q), (x0, y0 + q, s, s - q)],
        T.PART_2NxnD: [(x0, y0, s, s - q), (x0, y0 + s - q, s, q)],
        T.PART_nLx2N: [(x0, y0, q, s), (x0 + q, y0, s - q, s)],
        T.PART_nRx2N: [(x0, y0, s - q, s), (x0 + s - q, y0, q, s)],
    }[part_mode]


def _gather_windows(ref, xs, ys, w, h, pad):
    """(B, h+pad-1, w+pad-1) windows at (xs-off, ys-off) with edge clamp."""
    hh, ww = ref.shape
    b = len(xs)
    ry = np.clip(ys[:, None] + np.arange(h + pad - 1)[None, :], 0, hh - 1)
    rx = np.clip(xs[:, None] + np.arange(w + pad - 1)[None, :], 0, ww - 1)
    return ref[ry[:, :, None], rx[:, None, :]].astype(np.int32)


def _interp_group(ref, xs_int, ys_int, xf, yf, w, h, bit_depth, taps, filt):
    """Batched fractional interpolation for PUs sharing one ref plane and
    one (w, h); per-PU fractional phases. Returns (B, h, w) 14-bit."""
    shift1 = bit_depth - 8
    shift2 = 6
    shift3 = 14 - bit_depth
    off = taps // 2 - 1
    win = _gather_windows(ref, xs_int - off, ys_int - off, w, h, taps)
    fh = filt[xf]  # (B, taps)
    fv = filt[yf]
    b = win.shape[0]

    pure_full = (xf == 0) & (yf == 0)
    # horizontal stage over all rows: unrolled per-tap accumulation (the
    # per-PU filter rows make this a broadcasted MAC, much faster than an
    # einsum over strided sliding windows). int32 is exact: |acc| is
    # bounded by max_sample * sum|coeff| < 2^23 even at 10 bits.
    tmp = fh[:, 0, None, None] * win[:, :, 0:w]
    for k in range(1, taps):
        tmp += fh[:, k, None, None] * win[:, :, k:k + w]
    tmp >>= shift1
    # vertical stage (int64: intermediates reach ~2^25 * sum|coeff|)
    out = np.zeros((b, h, w), np.int64)
    for k in range(taps):
        out += fv[:, k, None, None] * tmp[:, k:k + h, :]
    out >>= shift2

    # pure-phase corrections (match spec exactly)
    h_only = tmp[:, off:off + h, :]                      # yf == 0
    wc = win[:, :, off:off + w]
    v_only = fv[:, 0, None, None] * wc[:, 0:h, :]
    for k in range(1, taps):
        v_only = v_only + fv[:, k, None, None] * wc[:, k:k + h, :]
    v_only >>= shift1
    center = win[:, off:off + h, off:off + w].astype(np.int64) << shift3

    out = np.where((yf == 0)[:, None, None], h_only, out)
    out = np.where(((xf == 0) & (yf != 0))[:, None, None], v_only, out)
    out = np.where(pure_full[:, None, None], center, out)
    return out


def reconstruct_inter_batch(plan, geom, ref_lists, recon):
    """MC + residual for all inter (incl. skip) CUs of the picture."""
    from turingcodec import native
    if native.inter_recon(plan, geom, ref_lists, recon):
        return
    sps = plan.sps
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    max_y, max_c = (1 << bd_y) - 1, (1 << bd_c) - 1

    # ---- collect PUs -----------------------------------------------------
    pus = []  # (x, y, w, h, l0info, l1info)
    inter_cus = []
    for cu in plan.cu_list:
        if cu.pred_mode != 0 or cu.pcm:
            continue
        inter_cus.append(cu)
        for (px, py, pw, ph) in _pu_geometry(cu, cu.part_mode):
            bx, by = px >> 2, py >> 2
            info = []
            for lx in (0, 1):
                r = int(plan.ref_idx[lx, by, bx])
                if r >= 0:
                    info.append((ref_lists[lx][r],
                                 int(plan.mv[lx, by, bx, 0]),
                                 int(plan.mv[lx, by, bx, 1])))
                else:
                    info.append(None)
            pus.append((px, py, pw, ph, info))
    if not pus:
        return

    # ---- batched MC: group by (w, h, ref identity, list) -----------------
    # accumulate per-PU 14-bit predictions, then finalize uni/bi
    acc = {}
    groups = {}
    for i, (px, py, pw, ph, info) in enumerate(pus):
        for lx in (0, 1):
            if info[lx] is None:
                continue
            ref, mvx, mvy = info[lx]
            groups.setdefault((pw, ph, id(ref), 0), []).append(
                (i, lx, ref, px + (mvx >> 2), py + (mvy >> 2),
                 mvx & 3, mvy & 3,
                 (px >> 1) + (mvx >> 3), (py >> 1) + (mvy >> 3),
                 mvx & 7, mvy & 7))
    pred14 = [[None, None] for _ in pus]   # luma
    pred14c = [[None, None] for _ in pus]  # (cb, cr)
    for (pw, ph, _, _), items in groups.items():
        ref = items[0][2]
        idxs = np.array([t[0] for t in items])
        lxs = [t[1] for t in items]
        xs = np.array([t[3] for t in items])
        ys = np.array([t[4] for t in items])
        xf = np.array([t[5] for t in items])
        yf = np.array([t[6] for t in items])
        py_ = _interp_group(ref.planes[0], xs, ys, xf, yf, pw, ph, bd_y,
                            8, LUMA_FILTER)
        cxs = np.array([t[7] for t in items])
        cys = np.array([t[8] for t in items])
        cxf = np.array([t[9] for t in items])
        cyf = np.array([t[10] for t in items])
        pcb = _interp_group(ref.planes[1], cxs, cys, cxf, cyf, pw >> 1,
                            ph >> 1, bd_c, 4, CHROMA_FILTER)
        pcr = _interp_group(ref.planes[2], cxs, cys, cxf, cyf, pw >> 1,
                            ph >> 1, bd_c, 4, CHROMA_FILTER)
        for k, (i, lx) in enumerate(zip(idxs, lxs)):
            pred14[i][lx] = py_[k]
            pred14c[i][lx] = (pcb[k], pcr[k])

    ry, rcb, rcr = recon
    for i, (px, py, pw, ph, info) in enumerate(pus):
        for (plane, max_v, bd, parts) in (
                (ry, max_y, bd_y, pred14[i]),
                (rcb, max_c, bd_c,
                 [p[0] if p else None for p in pred14c[i]]),
                (rcr, max_c, bd_c,
                 [p[1] if p else None for p in pred14c[i]])):
            shift = 14 - bd
            ps_ = [p for p in parts if p is not None]
            if len(ps_) == 2:
                v = (ps_[0] + ps_[1] + (1 << shift)) >> (shift + 1)
            else:
                v = (ps_[0] + (1 << (shift - 1))) >> shift
            v = np.clip(v, 0, max_v)
            if plane is ry:
                plane[py:py + ph, px:px + pw] = v
            else:
                plane[py >> 1:(py + ph) >> 1, px >> 1:(px + pw) >> 1] = v

    # ---- batched residuals ----------------------------------------------
    _inter_residuals_batch(plan, inter_cus, recon)


def _inter_residuals_batch(plan, inter_cus, recon):
    sps = plan.sps
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    groups = {}  # (log2, c_idx) -> list of (x, y, qp, bypass)
    from turingcodec.hevc.tables import chroma_qp_from_luma
    for cu in inter_cus:
        if cu.skip or not cu.tus:
            continue
        bx, by = cu.x0 >> 2, cu.y0 >> 2
        qp_y = int(plan.qp_y[by, bx]) + sps.qp_bd_offset_y
        sh = plan.slice_headers[int(
            plan.slice_idx[cu.y0 >> sps.ctb_log2_size_y,
                           cu.x0 >> sps.ctb_log2_size_y])]
        qp_cb = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c,
                min(57, int(plan.qp_y[by, bx]) + plan.pps.pps_cb_qp_offset
                    + sh.slice_cb_qp_offset))) + sps.qp_bd_offset_c
        qp_cr = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c,
                min(57, int(plan.qp_y[by, bx]) + plan.pps.pps_cr_qp_offset
                    + sh.slice_cr_qp_offset))) + sps.qp_bd_offset_c
        for (x0, y0, log2, blk_idx, xb, yb, cbf_y, cbf_cb, cbf_cr) in cu.tus:
            ts = plan.transform_skip_y[y0 >> 2, x0 >> 2]
            if cbf_y:
                groups.setdefault(("y", log2, bool(ts), cu.tq_bypass),
                                  []).append((x0, y0, qp_y))
            if log2 > 2:
                cx, cy, cl = x0 >> 1, y0 >> 1, log2 - 1
            elif blk_idx == 3:
                cx, cy, cl = xb >> 1, yb >> 1, 2
            else:
                continue
            if cbf_cb:
                tsc = plan.transform_skip_cb[cy >> 1, cx >> 1]
                groups.setdefault(("cb", cl, bool(tsc), cu.tq_bypass),
                                  []).append((cx, cy, qp_cb))
            if cbf_cr:
                tsc = plan.transform_skip_cr[cy >> 1, cx >> 1]
                groups.setdefault(("cr", cl, bool(tsc), cu.tq_bypass),
                                  []).append((cx, cy, qp_cr))

    from turingcodec.hevc.tables import LEVEL_SCALE, dct2_matrix
    ry, rcb, rcr = recon
    planes = {"y": (plan.coeff_y, ry, bd_y),
              "cb": (plan.coeff_cb, rcb, bd_c),
              "cr": (plan.coeff_cr, rcr, bd_c)}
    for (comp, log2, ts, bypass), items in groups.items():
        coeffp, rplane, bd = planes[comp]
        n = 1 << log2
        max_v = (1 << bd) - 1
        xs = np.array([t[0] for t in items])
        ys = np.array([t[1] for t in items])
        qps = np.array([t[2] for t in items])
        blocks = np.stack([coeffp[y:y + n, x:x + n]
                           for x, y in zip(xs, ys)]).astype(np.int64)
        if bypass:
            res = blocks.astype(np.int32)
        else:
            bd_shift = bd + log2 - 5
            ls = (LEVEL_SCALE[qps % 6].astype(np.int64) << (qps // 6)) * 16
            d = (blocks * ls[:, None, None] + (1 << (bd_shift - 1))) \
                >> bd_shift
            d = np.clip(d, -32768, 32767)
            if ts:
                bds2 = 20 - bd
                res = np.clip(((d << 7) + (1 << (bds2 - 1))) >> bds2,
                              -32768, 32767).astype(np.int32)
            else:
                m = dct2_matrix(n).astype(np.int64)
                e = np.matmul(m.T, d)   # e[b,y,x] = sum_k m[k,y] d[b,k,x]
                g = np.clip((e + 64) >> 7, -32768, 32767)
                r = np.matmul(g, m)     # r[b,y,x] = sum_k g[b,y,k] m[k,x]
                bds2 = 20 - bd
                res = np.clip((r + (1 << (bds2 - 1))) >> bds2,
                              -32768, 32767).astype(np.int32)
        for k, (x, y) in enumerate(zip(xs, ys)):
            blk = rplane[y:y + n, x:x + n].astype(np.int32) + res[k]
            rplane[y:y + n, x:x + n] = np.clip(blk, 0, max_v)
