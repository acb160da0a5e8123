"""Vectorized deblocking filter — numpy-batched over all edge segments at
once (bit-exact with decode/deblock.py, which remains the scalar oracle).

Independence argument: a vertical edge at x writes columns x-3..x+2 and reads
x-4..x+3; neighbouring vertical edges are >= 8 columns away, so all vertical
segments are data-independent and can be filtered simultaneously (likewise
horizontal, which runs on the vertically-filtered picture). This is exactly
the parallel structure the device twin uses.
"""
from __future__ import annotations

import numpy as np

from turingcodec.decode.deblock import BETA_TABLE, TC_TABLE
from turingcodec.hevc.tables import CHROMA_QP_TABLE_420
from turingcodec.decode.plan import PicturePlan


def deblock_picture_vec(plan: PicturePlan, geom, ry, rcb, rcr):
    from turingcodec import native
    if native.deblock(plan, geom, ry, rcb, rcr):
        return
    for vertical in (True, False):
        _deblock_dir_vec(plan, geom, ry, rcb, rcr, vertical)


def _motion_bs_vec(plan, byp, bxp, byq, bxq):
    """Vectorized motion-difference bS (arrays of block coords)."""
    r0p = plan.ref_idx[0, byp, bxp].astype(np.int32)
    r1p = plan.ref_idx[1, byp, bxp].astype(np.int32)
    r0q = plan.ref_idx[0, byq, bxq].astype(np.int32)
    r1q = plan.ref_idx[1, byq, bxq].astype(np.int32)
    np_cnt = (r0p >= 0).astype(np.int32) + (r1p >= 0)
    nq_cnt = (r0q >= 0).astype(np.int32) + (r1q >= 0)
    poc0p = plan.ref_poc[0, byp, bxp]
    poc1p = plan.ref_poc[1, byp, bxp]
    poc0q = plan.ref_poc[0, byq, bxq]
    poc1q = plan.ref_poc[1, byq, bxq]
    mv0p = plan.mv[0, byp, bxp].astype(np.int32)
    mv1p = plan.mv[1, byp, bxp].astype(np.int32)
    mv0q = plan.mv[0, byq, bxq].astype(np.int32)
    mv1q = plan.mv[1, byq, bxq].astype(np.int32)

    def dge4(a, b):
        return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
               (np.abs(a[..., 1] - b[..., 1]) >= 4)

    out = np.zeros(byp.shape, np.int32)
    # different hypothesis count -> 1
    out = np.where(np_cnt != nq_cnt, 1, out)
    same_cnt = np_cnt == nq_cnt

    # uni/uni
    uni = same_cnt & (np_cnt == 1)
    lp_poc = np.where(r0p >= 0, poc0p, poc1p)
    lq_poc = np.where(r0q >= 0, poc0q, poc1q)
    lp_mv = np.where((r0p >= 0)[..., None], mv0p, mv1p)
    lq_mv = np.where((r0q >= 0)[..., None], mv0q, mv1q)
    uni_bs = ((lp_poc != lq_poc) | dge4(lp_mv, lq_mv)).astype(np.int32)
    out = np.where(uni, uni_bs, out)

    # bi/bi
    bi = same_cnt & (np_cnt == 2)
    set_mismatch = ~(((poc0p == poc0q) & (poc1p == poc1q))
                     | ((poc0p == poc1q) & (poc1p == poc0q)))
    same_pic = poc0p == poc1p
    direct_ok = ~(dge4(mv0p, mv0q) | dge4(mv1p, mv1q))
    crossed_ok = ~(dge4(mv0p, mv1q) | dge4(mv1p, mv0q))
    # distinct pictures: match by picture
    match_direct = poc0p == poc0q
    distinct_bs = np.where(match_direct, ~direct_ok, ~crossed_ok)
    bi_bs = np.where(set_mismatch, True,
                     np.where(same_pic, ~(direct_ok | crossed_ok),
                              distinct_bs)).astype(np.int32)
    out = np.where(bi, bi_bs, out)
    return out


def _deblock_dir_vec(plan: PicturePlan, geom, ry, rcb, rcr, vertical: bool):
    sps, pps = plan.sps, plan.pps
    h, w = ry.shape
    bd_y = sps.bit_depth_y
    ctb_log2 = sps.ctb_log2_size_y

    if vertical:
        ex = np.arange(8, w, 8)
        sy = np.arange(0, h, 4)
        X, Y = np.meshgrid(ex, sy)          # (nseg_y, n_edges)
    else:
        ey = np.arange(8, h, 8)
        sx = np.arange(0, w, 4)
        X, Y = np.meshgrid(sx, ey)
    X = X.ravel()
    Y = Y.ravel()
    if vertical:
        bxp, byp = (X - 1) >> 2, Y >> 2
        bxq, byq = X >> 2, Y >> 2
    else:
        bxp, byp = X >> 2, (Y - 1) >> 2
        bxq, byq = X >> 2, Y >> 2

    # edge presence
    edge = ((plan.tu_id[byp, bxp] != plan.tu_id[byq, bxq])
            | (plan.pu_id[byp, bxp] != plan.pu_id[byq, bxq])
            | (plan.cu_id[byp, bxp] != plan.cu_id[byq, bxq]))

    # slice-level disable + boundary rules (per CTU maps)
    cxq, cyq = X >> ctb_log2, Y >> ctb_log2
    n_sl = len(plan.slice_headers)
    disabled = np.array([sh.slice_deblocking_filter_disabled_flag
                         for sh in plan.slice_headers], bool)
    across = np.array([sh.slice_loop_filter_across_slices_enabled_flag
                       for sh in plan.slice_headers], bool)
    beta_off = np.array([sh.slice_beta_offset_div2 << 1
                         for sh in plan.slice_headers], np.int32)
    tc_off = np.array([sh.slice_tc_offset_div2 << 1
                       for sh in plan.slice_headers], np.int32)
    sl_q = np.clip(plan.slice_idx[cyq, cxq], 0, n_sl - 1)
    edge &= ~disabled[sl_q]
    if vertical:
        cxp, cyp = (X - 1) >> ctb_log2, cyq
    else:
        cxp, cyp = cxq, (Y - 1) >> ctb_log2
    diff_slice = plan.slice_idx[cyp, cxp] != plan.slice_idx[cyq, cxq]
    edge &= ~(diff_slice & ~across[sl_q])
    if geom.num_tiles > 1:
        diff_tile = geom.tile_id[cyp, cxp] != geom.tile_id[cyq, cxq]
        edge &= ~(diff_tile & ~bool(pps.loop_filter_across_tiles_enabled_flag))

    # boundary strength
    intra_edge = (plan.cu_pred_mode[byp, bxp] == 1) | \
                 (plan.cu_pred_mode[byq, bxq] == 1)
    tu_edge = plan.tu_id[byp, bxp] != plan.tu_id[byq, bxq]
    cbf_any = (plan.cbf_y[byp, bxp] > 0) | (plan.cbf_y[byq, bxq] > 0)
    bs = np.where(intra_edge, 2,
                  np.where(tu_edge & cbf_any, 1,
                           _motion_bs_vec(plan, byp, bxp, byq, bxq)))
    sel = edge & (bs > 0)
    if vertical:
        sel &= Y + 3 < h
    else:
        sel &= X + 3 < w
    idx = np.nonzero(sel)[0]
    if idx.size:
        _filter_luma_vec(plan, ry, X[idx], Y[idx], bs[idx],
                         byp[idx], bxp[idx], byq[idx], bxq[idx],
                         beta_off[sl_q[idx]], tc_off[sl_q[idx]],
                         vertical, bd_y)

    # chroma: bS == 2 on the 16-luma grid
    if sps.chroma_array_type == 1:
        csel = edge & (bs == 2) & ((X if vertical else Y) % 16 == 0)
        cidx = np.nonzero(csel)[0]
        if cidx.size:
            _filter_chroma_vec(plan, rcb, rcr, X[cidx], Y[cidx],
                               byp[cidx], bxp[cidx], byq[cidx], bxq[cidx],
                               tc_off[sl_q[cidx]], vertical)


def _filter_luma_vec(plan, r, X, Y, bs, byp, bxp, byq, bxq,
                     beta_off, tc_off, vertical, bd):
    n = X.size
    max_val = (1 << bd) - 1
    qp_p = plan.qp_y[byp, bxp].astype(np.int32)
    qp_q = plan.qp_y[byq, bxq].astype(np.int32)
    qpl = (qp_p + qp_q + 1) >> 1
    qb = np.clip(qpl + beta_off, 0, 51)
    beta = BETA_TABLE[qb] << (bd - 8)
    qt = np.clip(qpl + 2 * (bs - 1) + tc_off, 0, 53)
    tc = TC_TABLE[qt] << (bd - 8)

    # window: win[s, i, k] i=line 0..3, k=0..7 -> p3..q3
    di = np.arange(4)
    dk = np.arange(-4, 4)
    if vertical:
        rows = Y[:, None, None] + di[None, :, None]
        cols = X[:, None, None] + dk[None, None, :]
    else:
        rows = Y[:, None, None] + dk[None, None, :]
        cols = X[:, None, None] + di[None, :, None]
    win = r[rows, cols].astype(np.int32)
    p3, p2, p1, p0 = win[:, :, 0], win[:, :, 1], win[:, :, 2], win[:, :, 3]
    q0, q1, q2, q3 = win[:, :, 4], win[:, :, 5], win[:, :, 6], win[:, :, 7]

    dp0 = np.abs(p2[:, 0] - 2 * p1[:, 0] + p0[:, 0])
    dp3 = np.abs(p2[:, 3] - 2 * p1[:, 3] + p0[:, 3])
    dq0 = np.abs(q2[:, 0] - 2 * q1[:, 0] + q0[:, 0])
    dq3 = np.abs(q2[:, 3] - 2 * q1[:, 3] + q0[:, 3])
    d = dp0 + dp3 + dq0 + dq3
    act = d < beta
    if not act.any():
        return

    def dsam(i, dpq):
        return ((2 * dpq < (beta >> 2))
                & (np.abs(p3[:, i] - p0[:, i]) + np.abs(q0[:, i] - q3[:, i])
                   < (beta >> 3))
                & (np.abs(p0[:, i] - q0[:, i]) < ((5 * tc + 1) >> 1)))

    strong = dsam(0, dp0 + dq0) & dsam(3, dp3 + dq3)

    t2 = (2 * tc)[:, None]
    tcv = tc[:, None]

    # strong filter outputs
    sp0 = np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                  p0 - t2, p0 + t2)
    sp1 = np.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2)
    sp2 = np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - t2, p2 + t2)
    sq0 = np.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                  q0 - t2, q0 + t2)
    sq1 = np.clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - t2, q1 + t2)
    sq2 = np.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - t2, q2 + t2)

    # weak filter
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wmask = np.abs(delta) < (tc * 10)[:, None]
    dlt = np.clip(delta, -tcv, tcv)
    wp0 = np.clip(p0 + dlt, 0, max_val)
    wq0 = np.clip(q0 - dlt, 0, max_val)
    d_ep = (dp0 + dp3 < ((beta + (beta >> 1)) >> 3))[:, None]
    d_eq = (dq0 + dq3 < ((beta + (beta >> 1)) >> 3))[:, None]
    tch = (tc >> 1)[:, None]
    dp = np.clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tch, tch)
    wq_p1 = np.clip(p1 + dp, 0, max_val)
    dq = np.clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tch, tch)
    wq_q1 = np.clip(q1 + dq, 0, max_val)

    act2 = act[:, None]
    strong2 = strong[:, None]
    out_p0 = np.where(act2, np.where(strong2, np.clip(sp0, 0, max_val),
                                     np.where(wmask, wp0, p0)), p0)
    out_p1 = np.where(act2, np.where(strong2, np.clip(sp1, 0, max_val),
                                     np.where(wmask & d_ep, wq_p1, p1)), p1)
    out_p2 = np.where(act2 & strong2, np.clip(sp2, 0, max_val), p2)
    out_q0 = np.where(act2, np.where(strong2, np.clip(sq0, 0, max_val),
                                     np.where(wmask, wq0, q0)), q0)
    out_q1 = np.where(act2, np.where(strong2, np.clip(sq1, 0, max_val),
                                     np.where(wmask & d_eq, wq_q1, q1)), q1)
    out_q2 = np.where(act2 & strong2, np.clip(sq2, 0, max_val), q2)

    outw = win.copy()
    outw[:, :, 1] = out_p2
    outw[:, :, 2] = out_p1
    outw[:, :, 3] = out_p0
    outw[:, :, 4] = out_q0
    outw[:, :, 5] = out_q1
    outw[:, :, 6] = out_q2
    r[rows, cols] = outw.astype(r.dtype)


def _filter_chroma_vec(plan, rcb, rcr, X, Y, byp, bxp, byq, bxq,
                       tc_off, vertical):
    sps, pps = plan.sps, plan.pps
    bd_c = sps.bit_depth_c
    max_val = (1 << bd_c) - 1
    qp_p = plan.qp_y[byp, bxp].astype(np.int32)
    qp_q = plan.qp_y[byq, bxq].astype(np.int32)
    n_sl = len(plan.slice_headers)
    # per-slice chroma offsets of the Q CTU
    ctb_log2 = sps.ctb_log2_size_y
    sl_q = np.clip(plan.slice_idx[Y >> ctb_log2, X >> ctb_log2], 0, n_sl - 1)
    cb_off = np.array([pps.pps_cb_qp_offset + sh.slice_cb_qp_offset
                       for sh in plan.slice_headers], np.int32)[sl_q]
    cr_off = np.array([pps.pps_cr_qp_offset + sh.slice_cr_qp_offset
                       for sh in plan.slice_headers], np.int32)[sl_q]

    h2, w2 = rcb.shape
    for plane, off in ((rcb, cb_off), (rcr, cr_off)):
        qpi = np.clip(((qp_p + qp_q + 1) >> 1) + off, -sps.qp_bd_offset_c, 57)
        qpc = CHROMA_QP_TABLE_420[np.clip(qpi, 0, 57)]
        qpc = np.where(qpi < 0, qpi, qpc)
        qt = np.clip(qpc + 2 + tc_off, 0, 53)
        tc = TC_TABLE[qt] << (bd_c - 8)
        # 2 chroma lines per 4-luma segment
        cx, cy = X >> 1, Y >> 1
        di = np.arange(2)
        dk = np.arange(-2, 2)
        if vertical:
            rows = cy[:, None, None] + di[None, :, None]
            cols = cx[:, None, None] + dk[None, None, :]
            rows = np.minimum(rows, h2 - 1)
        else:
            rows = cy[:, None, None] + dk[None, None, :]
            cols = cx[:, None, None] + di[None, :, None]
            cols = np.minimum(cols, w2 - 1)
        win = plane[rows, cols].astype(np.int32)
        p1, p0, q0, q1 = win[:, :, 0], win[:, :, 1], win[:, :, 2], win[:, :, 3]
        tcv = tc[:, None]
        delta = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tcv, tcv)
        np0 = np.clip(p0 + delta, 0, max_val)
        nq0 = np.clip(q0 - delta, 0, max_val)
        mask = (tc > 0)[:, None]
        outw = win.copy()
        outw[:, :, 1] = np.where(mask, np0, p0)
        outw[:, :, 2] = np.where(mask, nq0, q0)
        plane[rows, cols] = outw.astype(plane.dtype)
