"""Device (XLA) deblocking filter twin of decode/deblock_vec.py.

Dense formulation: no gather/scatter with data-dependent indices —
every 4-line edge segment in the picture is processed as one lane of a
dense (segments, edges) batch, with inactive segments masked to
passthrough. The written windows of neighbouring edges tile the sample
grid exactly (a vertical edge at x rewrites columns x-4..x+3; edges are 8
apart), so the whole direction pass is reshape -> filter -> reshape, which
XLA lowers to pure element-wise work with no scatter at all. The
horizontal pass reuses the vertical routine on transposed planes (the
filter is symmetric under transposition with p=above -> p=left).

Bit-exact with the numpy twin (asserted by tests/test_device_deblock.py);
both mirror the scalar oracle decode/deblock.py (reference:
turing/LoopFilter.h:425-608).
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from turingcodec.decode.deblock import BETA_TABLE, TC_TABLE
from turingcodec.hevc.tables import CHROMA_QP_TABLE_420

_BETA = jnp.asarray(BETA_TABLE, jnp.int32)
_TC = jnp.asarray(TC_TABLE, jnp.int32)
_CQP = jnp.asarray(CHROMA_QP_TABLE_420, jnp.int32)


def _motion_bs(ref_idx, ref_poc, mv, byp, bxp, byq, bxq):
    """Motion-difference bS on (S, E) grids (deblock_vec._motion_bs_vec)."""
    r0p = ref_idx[0, byp, bxp].astype(jnp.int32)
    r1p = ref_idx[1, byp, bxp].astype(jnp.int32)
    r0q = ref_idx[0, byq, bxq].astype(jnp.int32)
    r1q = ref_idx[1, byq, bxq].astype(jnp.int32)
    np_cnt = (r0p >= 0).astype(jnp.int32) + (r1p >= 0)
    nq_cnt = (r0q >= 0).astype(jnp.int32) + (r1q >= 0)
    poc0p = ref_poc[0, byp, bxp]
    poc1p = ref_poc[1, byp, bxp]
    poc0q = ref_poc[0, byq, bxq]
    poc1q = ref_poc[1, byq, bxq]
    mv0p = mv[0, byp, bxp].astype(jnp.int32)
    mv1p = mv[1, byp, bxp].astype(jnp.int32)
    mv0q = mv[0, byq, bxq].astype(jnp.int32)
    mv1q = mv[1, byq, bxq].astype(jnp.int32)

    def dge4(a, b):
        return (jnp.abs(a[..., 0] - b[..., 0]) >= 4) | \
               (jnp.abs(a[..., 1] - b[..., 1]) >= 4)

    out = jnp.zeros(byp.shape, jnp.int32)
    out = jnp.where(np_cnt != nq_cnt, 1, out)
    same_cnt = np_cnt == nq_cnt

    uni = same_cnt & (np_cnt == 1)
    lp_poc = jnp.where(r0p >= 0, poc0p, poc1p)
    lq_poc = jnp.where(r0q >= 0, poc0q, poc1q)
    lp_mv = jnp.where((r0p >= 0)[..., None], mv0p, mv1p)
    lq_mv = jnp.where((r0q >= 0)[..., None], mv0q, mv1q)
    uni_bs = ((lp_poc != lq_poc) | dge4(lp_mv, lq_mv)).astype(jnp.int32)
    out = jnp.where(uni, uni_bs, out)

    bi = same_cnt & (np_cnt == 2)
    set_mismatch = ~(((poc0p == poc0q) & (poc1p == poc1q))
                     | ((poc0p == poc1q) & (poc1p == poc0q)))
    same_pic = poc0p == poc1p
    direct_ok = ~(dge4(mv0p, mv0q) | dge4(mv1p, mv1q))
    crossed_ok = ~(dge4(mv0p, mv1q) | dge4(mv1p, mv0q))
    match_direct = poc0p == poc0q
    distinct_bs = jnp.where(match_direct, ~direct_ok, ~crossed_ok)
    bi_bs = jnp.where(set_mismatch, True,
                      jnp.where(same_pic, ~(direct_ok | crossed_ok),
                                distinct_bs)).astype(jnp.int32)
    return jnp.where(bi, bi_bs, out)


def _dir_pass(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
              across_tiles, chroma):
    """One direction over transposed-or-not planes: 'vertical' edges at
    x in 8Z, 4-line segments. Returns updated (ry, rcb, rcr)."""
    (tu_id, pu_id, cu_id, pred_mode, cbf_y, ref_idx, ref_poc, mv, qp_y,
     slice_idx, tile_id) = maps
    (disabled, across, beta_off_s, tc_off_s, cb_off_s, cr_off_s) = sl
    h, w = ry.shape
    n_e = w // 8 - 1
    n_s = h // 4
    X = (8 * (jnp.arange(n_e) + 1))[None, :]        # (1, E)
    Y = (4 * jnp.arange(n_s))[:, None]              # (S, 1)
    bxp, byp = (X - 1) >> 2, jnp.broadcast_to(Y >> 2, (n_s, n_e))
    bxq = jnp.broadcast_to(X >> 2, (n_s, n_e))
    byq = byp

    edge = ((tu_id[byp, bxp] != tu_id[byq, bxq])
            | (pu_id[byp, bxp] != pu_id[byq, bxq])
            | (cu_id[byp, bxp] != cu_id[byq, bxq]))

    cxq, cyq = X >> ctb_log2, jnp.broadcast_to(Y >> ctb_log2, (n_s, n_e))
    cxp = (X - 1) >> ctb_log2
    n_sl = disabled.shape[0]
    sl_q = jnp.clip(slice_idx[cyq, jnp.broadcast_to(cxq, (n_s, n_e))],
                    0, n_sl - 1)
    edge &= ~disabled[sl_q]
    diff_slice = (slice_idx[cyq, jnp.broadcast_to(cxp, (n_s, n_e))]
                  != slice_idx[cyq, jnp.broadcast_to(cxq, (n_s, n_e))])
    edge &= ~(diff_slice & ~across[sl_q])
    diff_tile = (tile_id[cyq, jnp.broadcast_to(cxp, (n_s, n_e))]
                 != tile_id[cyq, jnp.broadcast_to(cxq, (n_s, n_e))])
    edge &= ~(diff_tile & jnp.logical_not(across_tiles))

    intra_edge = (pred_mode[byp, bxp] == 1) | (pred_mode[byq, bxq] == 1)
    tu_edge = tu_id[byp, bxp] != tu_id[byq, bxq]
    cbf_any = (cbf_y[byp, bxp] > 0) | (cbf_y[byq, bxq] > 0)
    bs = jnp.where(intra_edge, 2,
                   jnp.where(tu_edge & cbf_any, 1,
                             _motion_bs(ref_idx, ref_poc, mv,
                                        byp, bxp, byq, bxq)))
    sel = edge & (bs > 0)

    # ---- luma filter on the tiled window view -------------------------
    beta_off = beta_off_s[sl_q]
    tc_off = tc_off_s[sl_q]
    max_val = (1 << bd_y) - 1
    qp_p = qp_y[byp, bxp].astype(jnp.int32)
    qp_q = qp_y[byq, bxq].astype(jnp.int32)
    qpl = (qp_p + qp_q + 1) >> 1
    qb = jnp.clip(qpl + beta_off, 0, 51)
    beta = _BETA[qb] << (bd_y - 8)
    qt = jnp.clip(qpl + 2 * (bs - 1) + tc_off, 0, 53)
    tc = _TC[qt] << (bd_y - 8)

    # windows: ry[:, 4 : 4+8*n_e] -> (S, 4, E, 8) -> (S, E, 4, 8)
    mid = ry[:, 4:4 + 8 * n_e].reshape(n_s, 4, n_e, 8)
    win = jnp.transpose(mid, (0, 2, 1, 3)).astype(jnp.int32)
    p3, p2, p1, p0 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    q0, q1, q2, q3 = win[..., 4], win[..., 5], win[..., 6], win[..., 7]

    dp0 = jnp.abs(p2[..., 0] - 2 * p1[..., 0] + p0[..., 0])
    dp3 = jnp.abs(p2[..., 3] - 2 * p1[..., 3] + p0[..., 3])
    dq0 = jnp.abs(q2[..., 0] - 2 * q1[..., 0] + q0[..., 0])
    dq3 = jnp.abs(q2[..., 3] - 2 * q1[..., 3] + q0[..., 3])
    d = dp0 + dp3 + dq0 + dq3
    act = sel & (d < beta)

    def dsam(i, dpq):
        return ((2 * dpq < (beta >> 2))
                & (jnp.abs(p3[..., i] - p0[..., i])
                   + jnp.abs(q0[..., i] - q3[..., i]) < (beta >> 3))
                & (jnp.abs(p0[..., i] - q0[..., i]) < ((5 * tc + 1) >> 1)))

    strong = dsam(0, dp0 + dq0) & dsam(3, dp3 + dq3)

    t2 = (2 * tc)[..., None]
    tcv = tc[..., None]
    sp0 = jnp.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   p0 - t2, p0 + t2)
    sp1 = jnp.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2)
    sp2 = jnp.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                   p2 - t2, p2 + t2)
    sq0 = jnp.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                   q0 - t2, q0 + t2)
    sq1 = jnp.clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - t2, q1 + t2)
    sq2 = jnp.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                   q2 - t2, q2 + t2)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wmask = jnp.abs(delta) < (tc * 10)[..., None]
    dlt = jnp.clip(delta, -tcv, tcv)
    wp0 = jnp.clip(p0 + dlt, 0, max_val)
    wq0 = jnp.clip(q0 - dlt, 0, max_val)
    d_ep = (dp0 + dp3 < ((beta + (beta >> 1)) >> 3))[..., None]
    d_eq = (dq0 + dq3 < ((beta + (beta >> 1)) >> 3))[..., None]
    tch = (tc >> 1)[..., None]
    dp = jnp.clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tch, tch)
    wq_p1 = jnp.clip(p1 + dp, 0, max_val)
    dq = jnp.clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tch, tch)
    wq_q1 = jnp.clip(q1 + dq, 0, max_val)

    act2 = act[..., None]
    strong2 = strong[..., None]
    out_p0 = jnp.where(act2, jnp.where(strong2, jnp.clip(sp0, 0, max_val),
                                       jnp.where(wmask, wp0, p0)), p0)
    out_p1 = jnp.where(act2, jnp.where(strong2, jnp.clip(sp1, 0, max_val),
                                       jnp.where(wmask & d_ep, wq_p1, p1)),
                       p1)
    out_p2 = jnp.where(act2 & strong2, jnp.clip(sp2, 0, max_val), p2)
    out_q0 = jnp.where(act2, jnp.where(strong2, jnp.clip(sq0, 0, max_val),
                                       jnp.where(wmask, wq0, q0)), q0)
    out_q1 = jnp.where(act2, jnp.where(strong2, jnp.clip(sq1, 0, max_val),
                                       jnp.where(wmask & d_eq, wq_q1, q1)),
                       q1)
    out_q2 = jnp.where(act2 & strong2, jnp.clip(sq2, 0, max_val), q2)

    outw = jnp.stack([p3, out_p2, out_p1, out_p0,
                      out_q0, out_q1, out_q2, q3], axis=-1)
    mid_out = jnp.transpose(outw, (0, 2, 1, 3)).reshape(n_s * 4, n_e * 8)
    ry_out = jnp.concatenate(
        [ry[:, :4], mid_out.astype(ry.dtype), ry[:, 4 + 8 * n_e:]], axis=1)

    if not chroma:
        return ry_out, rcb, rcr

    # ---- chroma: bS == 2 on the 16-luma grid --------------------------
    # chroma edges are every second luma edge (x = 16, 32, ..., last < w)
    m = (w - 1) // 16
    if m < 1:
        return ry_out, rcb, rcr
    e_idx = 2 * jnp.arange(m) + 1                   # luma edge index
    cbs = bs[:, e_idx]
    csel = sel[:, e_idx] & (cbs == 2)
    qp_pc = qp_p[:, e_idx]
    qp_qc = qp_q[:, e_idx]
    tc_offc = tc_off[:, e_idx]
    sl_qc = sl_q[:, e_idx]
    max_c = (1 << bd_c) - 1
    h2, w2 = rcb.shape

    def one_plane(plane, off_s):
        off = off_s[sl_qc]
        qp_bd_off_c = 6 * (bd_c - 8)
        qpi = jnp.clip(((qp_pc + qp_qc + 1) >> 1) + off, -qp_bd_off_c, 57)
        qpc = _CQP[jnp.clip(qpi, 0, 57)]
        qpc = jnp.where(qpi < 0, qpi, qpc)
        qt_c = jnp.clip(qpc + 2 + tc_offc, 0, 53)
        tc_c = _TC[qt_c] << (bd_c - 8)
        # window view: plane[:, 6 : 6+8m] -> (S, 2, m, 8), first 4 cols.
        # When w is not a multiple of 16 the last 8-group's unwritten tail
        # extends past the plane edge; pad right (never written back).
        pad = max(0, 6 + 8 * m - w2)
        planep = (jnp.pad(plane, ((0, 0), (0, pad)), mode="edge")
                  if pad else plane)
        midc = planep[:, 6:6 + 8 * m].reshape(n_s, 2, m, 8)
        winc = jnp.transpose(midc, (0, 2, 1, 3)).astype(jnp.int32)
        p1c, p0c = winc[..., 0], winc[..., 1]
        q0c, q1c = winc[..., 2], winc[..., 3]
        tcv_c = tc_c[..., None]
        dl = jnp.clip((((q0c - p0c) << 2) + p1c - q1c + 4) >> 3,
                      -tcv_c, tcv_c)
        np0 = jnp.clip(p0c + dl, 0, max_c)
        nq0 = jnp.clip(q0c - dl, 0, max_c)
        mask = (csel & (tc_c > 0))[..., None]
        o_p0 = jnp.where(mask, np0, p0c)
        o_q0 = jnp.where(mask, nq0, q0c)
        outc = jnp.stack([p1c, o_p0, o_q0, winc[..., 3],
                          winc[..., 4], winc[..., 5], winc[..., 6],
                          winc[..., 7]], axis=-1)
        midc_out = jnp.transpose(outc, (0, 2, 1, 3)).reshape(n_s * 2,
                                                             m * 8)
        out_full = jnp.concatenate(
            [planep[:, :6], midc_out.astype(plane.dtype),
             planep[:, 6 + 8 * m:]], axis=1)
        return out_full[:, :w2]

    rcb_out = one_plane(rcb, cb_off_s)
    rcr_out = one_plane(rcr, cr_off_s)
    return ry_out, rcb_out, rcr_out


def _transpose_maps(maps):
    (tu_id, pu_id, cu_id, pred_mode, cbf_y, ref_idx, ref_poc, mv, qp_y,
     slice_idx, tile_id) = maps
    t = lambda a: jnp.swapaxes(a, -2, -1)  # noqa: E731
    mv_t = jnp.swapaxes(mv, 1, 2)  # (2, w4, h4, 2); mv components stay
    return (t(tu_id), t(pu_id), t(cu_id), t(pred_mode), t(cbf_y),
            jnp.swapaxes(ref_idx, 1, 2), jnp.swapaxes(ref_poc, 1, 2),
            mv_t, t(qp_y), t(slice_idx), t(tile_id))


@partial(jax.jit, static_argnums=(5, 6, 7))
def deblock_device(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
                   across_tiles):
    """Full deblock (vertical then horizontal) on device arrays.

    mv swap note: mv is (2, h4, w4, 2) with components (x, y); under
    transposition the filter only uses |dx|>=4 | |dy|>=4, which is
    symmetric, so components are NOT swapped."""
    ry, rcb, rcr = _dir_pass(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
                             across_tiles, chroma=True)
    maps_t = _transpose_maps(maps)
    ry_t, rcb_t, rcr_t = _dir_pass(
        ry.T, rcb.T, rcr.T, maps_t, sl, ctb_log2, bd_y, bd_c,
        across_tiles, chroma=True)
    return ry_t.T, rcb_t.T, rcr_t.T


def deblock_picture_device(plan, geom, ry, rcb, rcr):
    """Numpy-in/numpy-out wrapper over the jitted device pass (drop-in for
    deblock_vec.deblock_picture_vec)."""
    sps, pps = plan.sps, plan.pps
    maps = (jnp.asarray(plan.tu_id), jnp.asarray(plan.pu_id),
            jnp.asarray(plan.cu_id), jnp.asarray(plan.cu_pred_mode),
            jnp.asarray(plan.cbf_y), jnp.asarray(plan.ref_idx),
            jnp.asarray(plan.ref_poc), jnp.asarray(plan.mv),
            jnp.asarray(plan.qp_y), jnp.asarray(plan.slice_idx),
            jnp.asarray(geom.tile_id))
    shs = plan.slice_headers
    sl = (jnp.asarray([bool(sh.slice_deblocking_filter_disabled_flag)
                       for sh in shs]),
          jnp.asarray([bool(sh.slice_loop_filter_across_slices_enabled_flag)
                       for sh in shs]),
          jnp.asarray([sh.slice_beta_offset_div2 << 1 for sh in shs],
                      jnp.int32),
          jnp.asarray([sh.slice_tc_offset_div2 << 1 for sh in shs],
                      jnp.int32),
          jnp.asarray([pps.pps_cb_qp_offset + sh.slice_cb_qp_offset
                       for sh in shs], jnp.int32),
          jnp.asarray([pps.pps_cr_qp_offset + sh.slice_cr_qp_offset
                       for sh in shs], jnp.int32))
    oy, ocb, ocr = deblock_device(
        jnp.asarray(ry), jnp.asarray(rcb), jnp.asarray(rcr), maps, sl,
        int(sps.ctb_log2_size_y), int(sps.bit_depth_y),
        int(sps.bit_depth_c),
        jnp.asarray(bool(pps.loop_filter_across_tiles_enabled_flag)
                    or geom.num_tiles == 1))
    ry[:] = np.asarray(oy)
    rcb[:] = np.asarray(ocb)
    rcr[:] = np.asarray(ocr)
