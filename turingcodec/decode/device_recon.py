"""Device (XLA) inter reconstruction: whole-picture motion compensation at
min-block granularity + size-bucketed batched residual IDCT, all as jitted
XLA ops consuming the plan tensors.

This is the pixel half of the device decode pipeline (SURVEY.md §7
stage 6 / ROADMAP full-picture device decode): the host CABAC parse fills
the PicturePlan; the device reconstructs every inter CU in a handful of
uniform batched ops — MC as one (B, 4, 4) block grid per list (batched
einsums inside ops/inter.mc_block_grid), residuals as per-size
(N, n, n) dequant+IDCT batches. Intra CUs, deblock and SAO follow on the
host (intra is serially dependent by spec).

Bit-exact with decode/recon_vec.py (asserted by tests/test_device_recon.py);
enable in the decoder with TURING_DEVICE_RECON=1.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from turingcodec.hevc.tables import chroma_qp_from_luma
from turingcodec.ops.inter import mc_block_grid
from turingcodec.ops.quant import dequant_batch
from turingcodec.ops.transform import inverse_transform_batch


def _combine_uni_bi(p0, p1, on0, on1, bd):
    """Default weighted sample prediction from 14-bit parts (8.5.3.3.4)."""
    shift = 14 - bd
    bi = (p0 + p1 + (1 << shift)) >> (shift + 1)
    uni0 = (p0 + (1 << (shift - 1))) >> shift
    uni1 = (p1 + (1 << (shift - 1))) >> shift
    on0 = on0[:, None, None]
    on1 = on1[:, None, None]
    v = jnp.where(on0 & on1, bi, jnp.where(on0, uni0, uni1))
    return jnp.clip(v, 0, (1 << bd) - 1)


def _mc_plane(refs, ref_sel, mvx, mvy, bx4, by4, on, bs, taps, shift_mv,
              bd):
    """One list's 14-bit predictions for all blocks (B, bs, bs)."""
    xi = bx4 * bs + (mvx >> shift_mv)
    yi = by4 * bs + (mvy >> shift_mv)
    frac_mask = (1 << shift_mv) - 1
    sel = jnp.where(on, ref_sel, 0)
    return mc_block_grid(refs, sel, xi, yi, mvx & frac_mask,
                         mvy & frac_mask, bs, taps, bd)


def _pad_pow2(n: int, lo: int = 16) -> int:
    """Next power-of-two >= max(n, lo): batch dims are padded to these
    buckets so XLA compiles one program per bucket instead of one per
    picture (each new shape is a compile)."""
    p = lo
    while p < n:
        p <<= 1
    return p


def reconstruct_inter_device(plan, geom, ref_lists, recon):
    """Device twin of recon_vec.reconstruct_inter_batch: MC + residual add
    for all inter CUs, writing into the [y, cb, cr] int16 planes."""
    sps = plan.sps
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    h4, w4 = geom.h4, geom.w4

    # ---- host prep: per-4x4-block motion ---------------------------------
    inter = (plan.cu_pred_mode == 0) & (plan.cu_id >= 0) & (
        (plan.ref_idx[0] >= 0) | (plan.ref_idx[1] >= 0))
    if not inter.any():
        return
    ref_stacks = []
    for lx in (0, 1):
        lst = ref_lists[lx] if lx < len(ref_lists) else []
        rpad = _pad_pow2(max(len(lst), 1), 1)
        planes = []
        for c in range(3):
            st = (np.stack([p.planes[c] for p in lst]) if lst else
                  np.zeros((1, *recon[c].shape), np.int16))
            if st.shape[0] < rpad:
                st = np.concatenate(
                    [st, np.zeros((rpad - st.shape[0], *st.shape[1:]),
                                  np.int16)])
            planes.append(st)
        ref_stacks.append(planes)

    by4, bx4 = np.nonzero(inter)
    nb = len(bx4)
    bpad = _pad_pow2(nb, 128)

    def padded(a, fill=0):
        out = np.full(bpad, fill, np.int32)
        out[:nb] = a
        return jnp.asarray(out)

    on = [None, None]
    p14_y = [None, None]
    p14_c = [[None, None], [None, None]]  # [cb/cr][list]
    for lx in (0, 1):
        r = plan.ref_idx[lx, by4, bx4].astype(np.int32)
        on_l = padded(r >= 0) > 0
        mvx = padded(plan.mv[lx, by4, bx4, 0].astype(np.int32))
        mvy = padded(plan.mv[lx, by4, bx4, 1].astype(np.int32))
        sel = padded(np.maximum(r, 0))
        jb_x = padded(bx4.astype(np.int32))
        jb_y = padded(by4.astype(np.int32))
        on[lx] = on_l
        p14_y[lx] = _mc_plane(jnp.asarray(ref_stacks[lx][0]), sel, mvx, mvy,
                              jb_x, jb_y, on_l, 4, 8, 2, bd_y)
        for c in (1, 2):
            p14_c[c - 1][lx] = _mc_plane(jnp.asarray(ref_stacks[lx][c]),
                                         sel, mvx, mvy, jb_x, jb_y, on_l,
                                         2, 4, 3, bd_c)

    pred_y = _combine_uni_bi(p14_y[0], p14_y[1], on[0], on[1], bd_y)
    pred_cb = _combine_uni_bi(p14_c[0][0], p14_c[0][1], on[0], on[1], bd_c)
    pred_cr = _combine_uni_bi(p14_c[1][0], p14_c[1][1], on[0], on[1], bd_c)

    # scatter the (B, bs, bs) blocks into the planes (blocks are disjoint;
    # padded tail discarded)
    py, pcb, pcr = (np.asarray(pred_y)[:nb], np.asarray(pred_cb)[:nb],
                    np.asarray(pred_cr)[:nb])
    recon[0].reshape(h4, 4, w4, 4).transpose(0, 2, 1, 3)[by4, bx4] = py
    recon[1].reshape(h4, 2, w4, 2).transpose(0, 2, 1, 3)[by4, bx4] = pcb
    recon[2].reshape(h4, 2, w4, 2).transpose(0, 2, 1, 3)[by4, bx4] = pcr

    # ---- residuals: size-bucketed batched dequant + IDCT ------------------
    _inter_residuals_device(plan, recon)


def _inter_residuals_device(plan, recon):
    sps = plan.sps
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    groups = {}
    for cu in plan.cu_list:
        if cu.pred_mode != 0 or cu.pcm or cu.skip or not cu.tus:
            continue
        # mode: 0 = dequant+IDCT, 1 = transform skip (dequant + shift),
        # 2 = transquant bypass (raw residual)
        cu_mode = 2 if cu.tq_bypass else 0
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
            if cbf_y:
                mode = cu_mode
                if not mode and plan.transform_skip_y[y0 >> 2, x0 >> 2]:
                    mode = 1
                groups.setdefault((0, log2, mode), []).append(
                    (x0, y0, qp_y))
            if log2 > 2:
                cx, cy, cl = x0 >> 1, y0 >> 1, log2 - 1
            elif blk_idx == 3:
                cx, cy, cl = xb >> 1, yb >> 1, 2
            else:
                continue
            if cbf_cb:
                mode = cu_mode
                if not mode and plan.transform_skip_cb[cy >> 1, cx >> 1]:
                    mode = 1
                groups.setdefault((1, cl, mode), []).append(
                    (cx, cy, qp_cb))
            if cbf_cr:
                mode = cu_mode
                if not mode and plan.transform_skip_cr[cy >> 1, cx >> 1]:
                    mode = 1
                groups.setdefault((2, cl, mode), []).append(
                    (cx, cy, qp_cr))

    planes = {0: (plan.coeff_y, recon[0], bd_y),
              1: (plan.coeff_cb, recon[1], bd_c),
              2: (plan.coeff_cr, recon[2], bd_c)}
    for (comp, log2, mode), items in groups.items():
        coeffp, rplane, bd = planes[comp]
        n = 1 << log2
        max_v = (1 << bd) - 1
        xs = np.array([t[0] for t in items])
        ys = np.array([t[1] for t in items])
        nblk = len(items)
        npad = _pad_pow2(nblk, 16)
        qpa = np.zeros(npad, np.int32)
        qpa[:nblk] = [t[2] for t in items]
        qpa[nblk:] = qpa[0]  # padded blocks: zero levels, any valid qp
        stacked = np.zeros((npad, n, n), np.int32)
        for k, (x, y) in enumerate(zip(xs, ys)):
            stacked[k] = coeffp[y:y + n, x:x + n]
        if mode == 2:  # transquant bypass: residual = parsed coefficients
            res = stacked[:nblk]
        elif mode == 1:  # transform skip (8.6.4.1): dequant + shift
            d = dequant_batch(jnp.asarray(stacked), jnp.asarray(qpa), bd,
                              log2)
            bds2 = 20 - bd
            res = jnp.clip(((d << 7) + (1 << (bds2 - 1))) >> bds2,
                           -32768, 32767)
            res = np.asarray(res)[:nblk]
        else:
            d = dequant_batch(jnp.asarray(stacked), jnp.asarray(qpa), bd,
                              log2)
            res = inverse_transform_batch(d, bd, False)
            res = np.asarray(res)[:nblk]
        for k, (x, y) in enumerate(zip(xs, ys)):
            blk = rplane[y:y + n, x:x + n].astype(np.int32) + res[k]
            rplane[y:y + n, x:x + n] = np.clip(blk, 0, max_v)
