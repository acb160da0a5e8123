"""Chained device decode pipeline: MC -> residual add -> (host intra) ->
deblock -> SAO with every intermediate resident on device and ONE
device->host pull per picture (two more when the picture has intra CUs).

The staged TURING_DEVICE_RECON/_DEBLOCK/_SAO paths pull each stage's
result back to the host (~15 syncs per picture); this pipeline pulls
once. It also keeps a device-resident DPB: each reconstructed picture's
planes stay in device memory and reference stacks are stacked
device-side instead of re-uploaded per picture (the device-resident DPB
of SURVEY.md §7 stage 6).

Runs when the Decoder's `device` choice is on (by default on a GPU
backend). Bit-exact with the host path
(tests/test_device_recon.py::test_device_pipeline_*); unsupported stream
shapes return None and the caller falls back to the host path.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

import jax.numpy as jnp

from turingcodec.decode.device_recon import (_combine_uni_bi, _mc_plane,
                                                 _pad_pow2)
from turingcodec.hevc.tables import chroma_qp_from_luma
from turingcodec.ops.quant import dequant_batch
from turingcodec.ops.transform import inverse_transform_batch

# device-resident DPB: id(host luma plane) -> (host planes, device planes).
# Holding the host arrays keeps the ids stable while cached.
_DEV_DPB: "OrderedDict[int, tuple]" = OrderedDict()
_DEV_DPB_MAX = 24


def _register_dev(planes, dev):
    _DEV_DPB[id(planes[0])] = (tuple(planes), dev)
    while len(_DEV_DPB) > _DEV_DPB_MAX:
        _DEV_DPB.popitem(last=False)


def _dev_planes_for(pic):
    ent = _DEV_DPB.get(id(pic.planes[0]))
    if ent is not None:
        _DEV_DPB.move_to_end(id(pic.planes[0]))
        return ent[1]
    dev = tuple(jnp.asarray(p) for p in pic.planes[:3])
    _register_dev(pic.planes, dev)
    return dev


def _scatter_blocks(plane, by, bx, blocks, bs):
    """Scatter disjoint bs-aligned (B, bs, bs) blocks at min-block coords
    (by, bx) into (H, W) plane; out-of-range coords (padding) drop."""
    h, w = plane.shape
    pr = plane.reshape(h // bs, bs, w // bs, bs).transpose(0, 2, 1, 3)
    pr = pr.at[by, bx].set(blocks.astype(plane.dtype), mode="drop")
    return pr.transpose(0, 2, 1, 3).reshape(h, w)


def _block_grid_add(plane, xs, ys, res, n, max_v):
    """Add residual (B, n, n) blocks at sample coords (xs, ys) (n-aligned,
    disjoint) and clip; padded entries carry out-of-range ys -> dropped."""
    rows = ys[:, None, None] + jnp.arange(n)[None, :, None]
    cols = xs[:, None, None] + jnp.arange(n)[None, None, :]
    cur = plane[rows, cols].astype(jnp.int32)  # reads clamp (harmless)
    val = jnp.clip(cur + res, 0, max_v).astype(plane.dtype)
    return plane.at[rows, cols].set(val, mode="drop")


def _mc_device(plan, geom, ref_lists, planes):
    """Whole-picture MC into the device planes (device_recon twin with the
    scatter on device)."""
    sps = plan.sps
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    inter = (plan.cu_pred_mode == 0) & (plan.cu_id >= 0) & (
        (plan.ref_idx[0] >= 0) | (plan.ref_idx[1] >= 0))
    if not inter.any():
        return planes
    stacks = []
    for lx in (0, 1):
        lst = ref_lists[lx] if lx < len(ref_lists) else []
        devs = [_dev_planes_for(p) for p in lst[:16]]
        if not devs:
            zero = tuple(jnp.zeros_like(p) for p in planes)
            devs = [zero]
        rpad = _pad_pow2(len(devs), 1)
        devs = devs + [devs[0]] * (rpad - len(devs))
        stacks.append([jnp.stack([d[c] for d in devs]) for c in range(3)])

    by4, bx4 = np.nonzero(inter)
    nb = len(bx4)
    bpad = _pad_pow2(nb, 128)
    h4 = planes[0].shape[0] // 4

    def padded(a, fill=0):
        out = np.full(bpad, fill, np.int32)
        out[:nb] = a
        return jnp.asarray(out)

    # padded block coords go out of range so the device scatter drops them
    jb_x = padded(bx4.astype(np.int32))
    jb_y = padded(by4.astype(np.int32), fill=h4)
    on = [None, None]
    p14_y = [None, None]
    p14_c = [[None, None], [None, None]]
    for lx in (0, 1):
        r = plan.ref_idx[lx, by4, bx4].astype(np.int32)
        on[lx] = padded(r >= 0) > 0
        mvx = padded(plan.mv[lx, by4, bx4, 0].astype(np.int32))
        mvy = padded(plan.mv[lx, by4, bx4, 1].astype(np.int32))
        sel = padded(np.maximum(r, 0))
        p14_y[lx] = _mc_plane(stacks[lx][0], sel, mvx, mvy, jb_x, jb_y,
                              on[lx], 4, 8, 2, bd_y)
        for c in (1, 2):
            p14_c[c - 1][lx] = _mc_plane(stacks[lx][c], sel, mvx, mvy,
                                         jb_x, jb_y, on[lx], 2, 4, 3, bd_c)
    pred_y = _combine_uni_bi(p14_y[0], p14_y[1], on[0], on[1], bd_y)
    pred_cb = _combine_uni_bi(p14_c[0][0], p14_c[0][1], on[0], on[1], bd_c)
    pred_cr = _combine_uni_bi(p14_c[1][0], p14_c[1][1], on[0], on[1], bd_c)
    jy = _scatter_blocks(planes[0], jb_y, jb_x, pred_y, 4)
    jcb = _scatter_blocks(planes[1], jb_y, jb_x, pred_cb, 2)
    jcr = _scatter_blocks(planes[2], jb_y, jb_x, pred_cr, 2)
    return [jy, jcb, jcr]


def _residuals_device(plan, planes):
    """Size-bucketed dequant+IDCT with the add/clip on device
    (device_recon._inter_residuals_device twin)."""
    sps = plan.sps
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    groups = {}
    for cu in plan.cu_list:
        if cu.pred_mode != 0 or cu.pcm or cu.skip or not cu.tus:
            continue
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
                groups.setdefault((0, log2, mode), []).append((x0, y0, qp_y))
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
                groups.setdefault((1, cl, mode), []).append((cx, cy, qp_cb))
            if cbf_cr:
                mode = cu_mode
                if not mode and plan.transform_skip_cr[cy >> 1, cx >> 1]:
                    mode = 1
                groups.setdefault((2, cl, mode), []).append((cx, cy, qp_cr))

    coeffs = {0: (plan.coeff_y, bd_y), 1: (plan.coeff_cb, bd_c),
              2: (plan.coeff_cr, bd_c)}
    for (comp, log2, mode), items in sorted(groups.items()):
        coeffp, bd = coeffs[comp]
        n = 1 << log2
        max_v = (1 << bd) - 1
        nblk = len(items)
        npad = _pad_pow2(nblk, 16)
        xs = np.zeros(npad, np.int32)
        ys = np.full(npad, planes[comp].shape[0], np.int32)  # pad: dropped
        qpa = np.zeros(npad, np.int32)
        stacked = np.zeros((npad, n, n), np.int32)
        for k, (x, y, qp) in enumerate(items):
            xs[k], ys[k], qpa[k] = x, y, qp
            stacked[k] = coeffp[y:y + n, x:x + n]
        qpa[nblk:] = qpa[0]
        if mode == 2:  # transquant bypass: residual = parsed coefficients
            res = jnp.asarray(stacked)
        elif mode == 1:  # transform skip (8.6.4.1)
            d = dequant_batch(jnp.asarray(stacked), jnp.asarray(qpa), bd,
                              log2)
            bds2 = 20 - bd
            res = jnp.clip(((d << 7) + (1 << (bds2 - 1))) >> bds2,
                           -32768, 32767)
        else:
            d = dequant_batch(jnp.asarray(stacked), jnp.asarray(qpa), bd,
                              log2)
            res = inverse_transform_batch(d, bd, False)
        planes[comp] = _block_grid_add(planes[comp], jnp.asarray(xs),
                                       jnp.asarray(ys), res, n, max_v)
    return planes


def _deblock_device(plan, geom, planes):
    from turingcodec.ops.deblock import deblock_device
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
    return list(deblock_device(
        planes[0], planes[1], planes[2], maps, sl,
        int(sps.ctb_log2_size_y), int(sps.bit_depth_y),
        int(sps.bit_depth_c),
        jnp.asarray(bool(pps.loop_filter_across_tiles_enabled_flag)
                    or geom.num_tiles == 1)))


def decode_picture_device(pr):
    """Run the chained device pipeline for a PictureReconstructor.

    Returns the final [y, cb, cr] host planes, or None when the stream
    shape is unsupported (caller falls back to the host path)."""
    import os
    import sys
    import time
    trace = bool(os.environ.get("TURING_PIPELINE_TRACE"))
    t0 = time.time()

    def tp(tag):
        if trace:
            print(f"    [pipeline] {tag:10s} +{time.time() - t0:6.2f}s",
                  file=sys.stderr, flush=True)

    plan, geom = pr.plan, pr.geom
    sps = plan.sps
    if (sps.chroma_array_type != 1 or pr.scaling is not None
            or plan.pcm_samples):
        return None

    planes = [jnp.asarray(pr.ry), jnp.asarray(pr.rcb), jnp.asarray(pr.rcr)]
    planes = _mc_device(plan, geom, pr.ref_lists, planes)
    tp("mc")
    planes = _residuals_device(plan, planes)
    tp("residual")

    has_intra = bool(((plan.cu_pred_mode == 1) & (plan.cu_id >= 0)).any())
    if has_intra:
        # the one serial-by-spec stage: pull, reconstruct intra CUs on the
        # host (native core), push back
        from turingcodec import native
        import jax
        got = jax.device_get(planes)  # ONE batched transfer, not three
        pr.ry[:], pr.rcb[:], pr.rcr[:] = got
        if not native.intra_recon(pr):
            for cu in plan.cu_list:
                if cu.pred_mode == 1:
                    pr._recon_intra_cu(cu)
        planes = [jnp.asarray(pr.ry), jnp.asarray(pr.rcb),
                  jnp.asarray(pr.rcr)]
    tp("intra")

    planes = _deblock_device(plan, geom, planes)
    tp("deblock")
    if any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
           for sh in plan.slice_headers):
        from turingcodec.ops.sao import sao_picture_device
        planes = sao_picture_device(plan, geom, planes, pull=False)

    tp("sao")
    # the single device->host pull of the pipeline: one batched
    # device_get for all three planes instead of three round-trips
    import jax
    planes = [p.astype(jnp.int16) for p in planes]
    out = [np.array(p, copy=True) for p in jax.device_get(planes)]
    tp("pull")
    pr.ry, pr.rcb, pr.rcr = out
    _register_dev(out, tuple(planes))
    return out
