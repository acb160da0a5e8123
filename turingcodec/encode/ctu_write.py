"""CTU-level CABAC writing from a PicturePlan (exact inverse of
decode/ctu_parse.py — the round-trip parse(write(plan)) == plan is tested).

Parity reference: turing/Write.h:510-676, turing/Binarization.h. Context
increments and scan derivations are shared with the parser.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from turingcodec.bitstream.writer import BitWriter
from turingcodec.cabac.engine import CabacEncoder, ContextPool, ctx_index
from turingcodec.hevc import types as T
from turingcodec.hevc.geometry import PictureGeometry
from turingcodec.hevc.params import SliceSegmentHeader
from turingcodec.decode.ctu_parse import _scan, _sig_ctx16
from turingcodec.decode.plan import PicturePlan


class SliceWriteContext:
    """Per-slice CABAC write state."""

    def __init__(self, plan: PicturePlan, geom: PictureGeometry,
                 sh: SliceSegmentHeader, slice_number: int):
        self.plan = plan
        self.geom = geom
        self.sps = plan.sps
        self.pps = plan.pps
        self.sh = sh
        self.slice_number = slice_number
        self.ctx = ContextPool()
        self.ctx.initialize(sh.init_type(), sh.slice_qp_y)
        self.bw = BitWriter()
        self.enc = CabacEncoder(self.bw, self.ctx)
        self.wpp_saved_ctx: Optional[ContextPool] = None
        self.cu = None
        # QP prediction chain (mirrors the parser's, spec 8.6.1)
        self.qp_y_pred = sh.slice_qp_y
        self.last_cu_qp = sh.slice_qp_y
        self.is_cu_qp_delta_coded = False
        self.cu_qp_delta_val = 0


def write_slice_data(plan: PicturePlan, geom: PictureGeometry,
                     sh: SliceSegmentHeader, slice_number: int,
                     init_state=None, end_ts=None):
    """Write all CTUs of a slice segment; returns (substreams, end_state).

    substreams: per-substream byte strings (one element unless WPP); the
    caller concatenates and computes entry points.
    init_state: (ContextPool, last_cu_qp) continuation for a dependent
    slice segment (spec 9.3.1: contexts carry over from the previous
    segment); end_ts: stop before this tile-scan address (dependent-segment
    boundaries are not visible in plan.slice_idx).
    end_state mirrors init_state for the next dependent segment."""
    sps, pps = plan.sps, plan.pps
    wc = sps.pic_width_in_ctbs_y
    wpp = bool(pps.entropy_coding_sync_enabled_flag)
    ws = SliceWriteContext(plan, geom, sh, slice_number)
    if init_state is not None:
        ctx0, last_qp = init_state
        ws.ctx.states = bytearray(ctx0.states)
        ws.last_cu_qp = last_qp
        ws.qp_y_pred = last_qp
    # native CABAC writer (write_core.cpp): whole-CTU bins + terminates;
    # the Python engine below stays as the oracle and fallback
    from turingcodec.native import WriterNative
    nat = WriterNative.try_create(plan, geom, sh, slice_number)
    substreams = []
    snap_rx = 1 if wc > 1 else 0

    n_ctus = geom.wc * geom.hc
    start_ts = int(geom.rs_to_ts[sh.slice_segment_address])
    tiles = bool(pps.tiles_enabled_flag)

    def subset_end(ts_next, tile_cur):
        """end_of_subset boundary before ts_next (WPP row / tile edge)."""
        if ts_next >= n_ctus:
            return False
        nrs = geom.tile_scan_ctus[ts_next]
        if wpp and nrs % wc == 0:
            return True
        return tiles and geom.tile_id[nrs // wc, nrs % wc] != tile_cur

    for ctb_addr_ts in range(start_ts, n_ctus):
        ctb_addr_rs = geom.tile_scan_ctus[ctb_addr_ts]
        rx, ry = ctb_addr_rs % wc, ctb_addr_rs // wc

        if tiles and ctb_addr_ts > start_ts:
            # tile start: fresh contexts + QP prediction chain (mirrors
            # decode/slice_data.py's tile re-init)
            prev_rs = geom.tile_scan_ctus[ctb_addr_ts - 1]
            if geom.tile_id[ry, rx] != geom.tile_id[prev_rs // wc,
                                                    prev_rs % wc]:
                ws.ctx.initialize(sh.init_type(), sh.slice_qp_y)
                ws.qp_y_pred = sh.slice_qp_y
                ws.last_cu_qp = sh.slice_qp_y

        if wpp and rx == 0 and ctb_addr_ts > start_ts:
            # start new substream: restore/init contexts
            up_ok = (ws.wpp_saved_ctx is not None
                     and plan.slice_idx[ry - 1, min(1, wc - 1)] == slice_number)
            if up_ok:
                ws.ctx.states = bytearray(ws.wpp_saved_ctx.states)
            else:
                ws.ctx.initialize(sh.init_type(), sh.slice_qp_y)
            ws.qp_y_pred = sh.slice_qp_y
            ws.last_cu_qp = sh.slice_qp_y

        if nat is not None:
            nat.write_ctu(ws, ctb_addr_rs)
        else:
            write_ctu(ws, ctb_addr_rs)
        if wpp and rx == snap_rx:
            ws.wpp_saved_ctx = ws.ctx.copy()

        last = ctb_addr_ts == n_ctus - 1
        if not last and end_ts is not None:
            last = ctb_addr_ts + 1 >= end_ts
        elif not last:
            nxt = geom.tile_scan_ctus[ctb_addr_ts + 1]
            last = plan.slice_idx[nxt // wc, nxt % wc] != slice_number
        if nat is not None:
            nat.encode_terminate(1 if last else 0)
            if last:
                substreams.append(nat.take_substream())
                break
            if subset_end(ctb_addr_ts + 1, geom.tile_id[ry, rx]):
                nat.encode_terminate(1)  # end_of_subset_one_bit
                substreams.append(nat.take_substream())
            continue
        ws.enc.encode_terminate(1 if last else 0)
        if last:
            # encode_terminate(1) flushed; align the substream
            if ws.bw.nbits:
                ws.bw.u(0, 8 - ws.bw.nbits)
            substreams.append(ws.bw.get_bytes())
            break
        if subset_end(ctb_addr_ts + 1, geom.tile_id[ry, rx]):
            ws.enc.encode_terminate(1)  # end_of_subset_one_bit
            ws.bw.u(0, 8 - ws.bw.nbits) if ws.bw.nbits else None
            substreams.append(ws.bw.get_bytes())
            ws.bw = BitWriter()
            ws.enc = CabacEncoder(ws.bw, ws.ctx)
    return substreams, (ws.ctx.copy(), ws.last_cu_qp)


def write_ctu(ws: SliceWriteContext, ctb_addr_rs: int):
    sps = ws.sps
    wc = sps.pic_width_in_ctbs_y
    rx, ry = ctb_addr_rs % wc, ctb_addr_rs // wc
    assert ws.plan.slice_idx[ry, rx] == ws.slice_number
    if ws.sh.slice_sao_luma_flag or ws.sh.slice_sao_chroma_flag:
        write_sao(ws, rx, ry)
    x0, y0 = rx << sps.ctb_log2_size_y, ry << sps.ctb_log2_size_y
    write_coding_quadtree(ws, x0, y0, sps.ctb_log2_size_y, 0)


def write_sao(ws: SliceWriteContext, rx: int, ry: int):
    """sao() writing: merge-left/up flags per plan.sao_merge (estimator
    RDO), explicit params otherwise."""
    plan, sh, enc = ws.plan, ws.sh, ws.enc
    sps = ws.sps
    merge = int(plan.sao_merge[ry, rx]) if plan.sao_merge is not None else 0
    if rx > 0 and plan.slice_idx[ry, rx - 1] == ws.slice_number \
            and ws.geom.tile_id[ry, rx] == ws.geom.tile_id[ry, rx - 1]:
        enc.encode_decision(ctx_index("sao_merge_flag"),
                            1 if merge == 1 else 0)
        if merge == 1:
            return
    if ry > 0 and plan.slice_idx[ry - 1, rx] == ws.slice_number \
            and ws.geom.tile_id[ry, rx] == ws.geom.tile_id[ry - 1, rx]:
        enc.encode_decision(ctx_index("sao_merge_flag"),
                            1 if merge == 2 else 0)
        if merge == 2:
            return
    for c_idx in range(3 if sps.chroma_array_type else 1):
        if c_idx == 0 and not sh.slice_sao_luma_flag:
            continue
        if c_idx > 0 and not sh.slice_sao_chroma_flag:
            continue
        t = int(plan.sao_type[ry, rx, c_idx])
        if c_idx <= 1:
            enc.encode_decision(ctx_index("sao_type_idx"), 1 if t else 0)
            if t:
                enc.encode_bypass(1 if t == 2 else 0)
        if t == 0:
            continue
        bd = sps.bit_depth_y if c_idx == 0 else sps.bit_depth_c
        c_max = (1 << (min(bd, 10) - 5)) - 1
        offsets = plan.sao_offsets[ry, rx, c_idx]
        for k in range(4):
            v = abs(int(offsets[k]))
            for i in range(min(v, c_max)):
                enc.encode_bypass(1)
            if v < c_max:
                enc.encode_bypass(0)
        if t == 1:
            for k in range(4):
                if offsets[k]:
                    enc.encode_bypass(1 if offsets[k] < 0 else 0)
            enc.encode_bypass_bits(int(plan.sao_class[ry, rx, c_idx]), 5)
        else:
            if c_idx <= 1:
                enc.encode_bypass_bits(int(plan.sao_class[ry, rx, c_idx]), 2)


def write_coding_quadtree(ws: SliceWriteContext, x0, y0, log2_size, depth):
    sps, pps, enc, plan = ws.sps, ws.pps, ws.enc, ws.plan
    w, h = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
    in_pic = x0 + (1 << log2_size) <= w and y0 + (1 << log2_size) <= h
    if pps.cu_qp_delta_enabled_flag and log2_size >= (
            sps.ctb_log2_size_y - pps.diff_cu_qp_delta_depth):
        ws.is_cu_qp_delta_coded = False
        ws.cu_qp_delta_val = 0
        ws.qp_y_pred = ws.last_cu_qp
    actual_depth = int(plan.ct_depth[y0 >> 2, x0 >> 2])
    split = actual_depth > depth
    if in_pic and log2_size > sps.min_cb_log2_size_y:
        inc = 0
        if ws.geom.available(plan.slice_idx, x0, y0, x0 - 1, y0):
            inc += int(plan.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth)
        if ws.geom.available(plan.slice_idx, x0, y0, x0, y0 - 1):
            inc += int(plan.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth)
        enc.encode_decision(ctx_index("split_cu_flag", inc), int(split))
    elif log2_size > sps.min_cb_log2_size_y:
        split = True  # forced split at picture boundary
    if split:
        half = 1 << (log2_size - 1)
        x1, y1 = x0 + half, y0 + half
        write_coding_quadtree(ws, x0, y0, log2_size - 1, depth + 1)
        if x1 < w:
            write_coding_quadtree(ws, x1, y0, log2_size - 1, depth + 1)
        if y1 < h:
            write_coding_quadtree(ws, x0, y1, log2_size - 1, depth + 1)
        if x1 < w and y1 < h:
            write_coding_quadtree(ws, x1, y1, log2_size - 1, depth + 1)
    else:
        write_coding_unit(ws, x0, y0, log2_size, depth)
        ws.last_cu_qp = int(plan.qp_y[y0 >> 2, x0 >> 2])


class _WriteCu:
    __slots__ = ("x0", "y0", "log2_size", "pred_mode", "part_mode",
                 "tq_bypass", "intra_split", "max_trafo_depth", "ct_depth")


def write_coding_unit(ws: SliceWriteContext, x0, y0, log2_size, depth):
    sps, pps, enc, plan, sh = ws.sps, ws.pps, ws.enc, ws.plan, ws.sh
    b = (y0 >> 2, x0 >> 2)
    cu = _WriteCu()
    cu.x0, cu.y0, cu.log2_size, cu.ct_depth = x0, y0, log2_size, depth
    cu.pred_mode = int(plan.cu_pred_mode[b])
    cu.tq_bypass = bool(plan.tq_bypass[b])
    ws.cu = cu

    if pps.transquant_bypass_enabled_flag:
        enc.encode_decision(ctx_index("cu_transquant_bypass_flag"),
                            int(cu.tq_bypass))

    if not sh.is_i:
        skip = bool(plan.skip_flag[b])
        inc = 0
        if ws.geom.available(plan.slice_idx, x0, y0, x0 - 1, y0):
            inc += int(plan.skip_flag[y0 >> 2, (x0 - 1) >> 2])
        if ws.geom.available(plan.slice_idx, x0, y0, x0, y0 - 1):
            inc += int(plan.skip_flag[(y0 - 1) >> 2, x0 >> 2])
        enc.encode_decision(ctx_index("cu_skip_flag", inc), int(skip))
        if skip:
            cu.pred_mode = 0
            if sh.max_num_merge_cand > 1:
                _write_merge_idx(ws, x0, y0)
            return
        enc.encode_decision(ctx_index("pred_mode_flag"), int(cu.pred_mode))

    if cu.pred_mode == 0:
        _write_inter_cu(ws, cu)
        return

    # intra path
    cu.part_mode = int(plan.part_mode[b])
    part_nxn = cu.part_mode == T.PART_NxN
    cu.intra_split = 1 if part_nxn else 0
    if log2_size == sps.min_cb_log2_size_y:
        enc.encode_decision(ctx_index("part_mode", 0), 0 if part_nxn else 1)
    else:
        assert not part_nxn
    assert not sps.pcm_enabled_flag

    _write_intra_modes(ws, cu)
    cu.max_trafo_depth = sps.max_transform_hierarchy_depth_intra + cu.intra_split
    write_transform_tree(ws, x0, y0, x0, y0, log2_size, 0, 0, 1, 1)


def _write_merge_idx(ws: SliceWriteContext, x0, y0):
    enc, sh = ws.enc, ws.sh
    idx = int(ws.plan.merge_idx[y0 >> 2, x0 >> 2])
    c_max = sh.max_num_merge_cand - 1
    enc.encode_decision(ctx_index("merge_idx"), 1 if idx else 0)
    if idx:
        for _ in range(idx - 1):
            enc.encode_bypass(1)
        if idx < c_max:
            enc.encode_bypass(0)


def _write_inter_part_mode(ws: SliceWriteContext, part_mode, log2_size):
    """part_mode binarization for inter CUs — inverse of
    ctu_parse._parse_inter_part_mode (spec 9.3.3.7)."""
    enc, sps = ws.enc, ws.sps
    if part_mode == T.PART_2Nx2N:
        enc.encode_decision(ctx_index("part_mode", 0), 1)
        return
    enc.encode_decision(ctx_index("part_mode", 0), 0)
    at_min = log2_size == sps.min_cb_log2_size_y
    amp = sps.amp_enabled_flag and not at_min
    horizontal = part_mode in (T.PART_2NxN, T.PART_2NxnU, T.PART_2NxnD)
    enc.encode_decision(ctx_index("part_mode", 1), 1 if horizontal else 0)
    if at_min:
        if part_mode == T.PART_2NxN:
            return
        if log2_size == 3:
            assert part_mode == T.PART_Nx2N
            return
        enc.encode_decision(ctx_index("part_mode", 2),
                            1 if part_mode == T.PART_Nx2N else 0)
        return
    if not amp:
        assert part_mode in (T.PART_2NxN, T.PART_Nx2N)
        return
    sym = part_mode in (T.PART_2NxN, T.PART_Nx2N)
    enc.encode_decision(ctx_index("part_mode", 3), 1 if sym else 0)
    if not sym:
        enc.encode_bypass(
            1 if part_mode in (T.PART_2NxnD, T.PART_nRx2N) else 0)


def _pu_rects(x0, y0, size, part_mode):
    h = size >> 1
    q = size >> 2
    if part_mode == T.PART_2Nx2N:
        return [(x0, y0, size, size)]
    if part_mode == T.PART_2NxN:
        return [(x0, y0, size, h), (x0, y0 + h, size, h)]
    if part_mode == T.PART_Nx2N:
        return [(x0, y0, h, size), (x0 + h, y0, h, size)]
    if part_mode == T.PART_2NxnU:
        return [(x0, y0, size, q), (x0, y0 + q, size, size - q)]
    if part_mode == T.PART_2NxnD:
        return [(x0, y0, size, size - q), (x0, y0 + size - q, size, q)]
    if part_mode == T.PART_nLx2N:
        return [(x0, y0, q, size), (x0 + q, y0, size - q, size)]
    if part_mode == T.PART_nRx2N:
        return [(x0, y0, size - q, size), (x0 + size - q, y0, q, size)]
    raise AssertionError(part_mode)


def _write_prediction_unit(ws: SliceWriteContext, cu, px, py, pw, ph):
    """prediction_unit() syntax for one PU (spec 7.3.8.6)."""
    enc, plan, sh = ws.enc, ws.plan, ws.sh
    b = (py >> 2, px >> 2)
    merge = bool(plan.merge_flag[b])
    enc.encode_decision(ctx_index("merge_flag"), int(merge))
    if merge:
        if sh.max_num_merge_cand > 1:
            _write_merge_idx(ws, px, py)
        return
    if sh.is_b:
        r0 = int(plan.ref_idx[0, b[0], b[1]])
        r1 = int(plan.ref_idx[1, b[0], b[1]])
        ipi = (1 if r0 >= 0 else 0) | (2 if r1 >= 0 else 0)
        if pw + ph != 12:
            enc.encode_decision(
                ctx_index("inter_pred_idc", cu.ct_depth),
                1 if ipi == 3 else 0)
        if ipi != 3:
            enc.encode_decision(ctx_index("inter_pred_idc", 4),
                                1 if ipi == 2 else 0)
    else:
        ipi = 1
    for lx in (0, 1):
        if not (ipi & (1 << lx)):
            continue
        nref = (sh.num_ref_idx_l0_active_minus1 if lx == 0
                else sh.num_ref_idx_l1_active_minus1)
        r = int(plan.ref_idx[lx, b[0], b[1]])
        if nref > 0:
            # TR: bins 0/1 context-coded (inc 0, 1), rest bypass
            for k in range(r):
                if k < 2:
                    enc.encode_decision(ctx_index("ref_idx", k), 1)
                else:
                    enc.encode_bypass(1)
            if r < nref:
                if r < 2:
                    enc.encode_decision(ctx_index("ref_idx", r), 0)
                else:
                    enc.encode_bypass(0)
        if lx == 1 and sh.mvd_l1_zero_flag and ipi == 3:
            pass
        else:
            _write_mvd(ws, int(plan.mvd[lx, b[0], b[1], 0]),
                       int(plan.mvd[lx, b[0], b[1], 1]))
        enc.encode_decision(ctx_index("mvp_flag"),
                            int(plan.mvp_flag[lx, b[0], b[1]]))


def _write_inter_cu(ws: SliceWriteContext, cu):
    """Inter CU: part_mode + per-PU syntax + transform tree."""
    enc, plan, sh, sps = ws.enc, ws.plan, ws.sh, ws.sps
    x0, y0, log2 = cu.x0, cu.y0, cu.log2_size
    b = (y0 >> 2, x0 >> 2)
    cu.part_mode = int(plan.part_mode[b])
    _write_inter_part_mode(ws, cu.part_mode, log2)

    size = 1 << log2
    for (px, py, pw, ph) in _pu_rects(x0, y0, size, cu.part_mode):
        _write_prediction_unit(ws, cu, px, py, pw, ph)
    merge = bool(plan.merge_flag[b])

    # rqt_root_cbf
    has_coeff = bool(
        plan.coeff_y[y0:y0 + size, x0:x0 + size].any()
        or plan.coeff_cb[y0 >> 1:(y0 + size) >> 1, x0 >> 1:(x0 + size) >> 1].any()
        or plan.coeff_cr[y0 >> 1:(y0 + size) >> 1, x0 >> 1:(x0 + size) >> 1].any())
    if not (cu.part_mode == T.PART_2Nx2N and merge):
        enc.encode_decision(ctx_index("rqt_root_cbf"), int(has_coeff))
    else:
        assert has_coeff, "merge 2Nx2N without residual must be skip"
    if has_coeff:
        cu.intra_split = 0
        cu.max_trafo_depth = sps.max_transform_hierarchy_depth_inter
        write_transform_tree(ws, x0, y0, x0, y0, log2, 0, 0, 1, 1)


def _write_mvd(ws: SliceWriteContext, mx, my):
    enc = ws.enc
    ax, ay = abs(mx), abs(my)
    enc.encode_decision(ctx_index("abs_mvd_greater0_flag"), int(ax > 0))
    enc.encode_decision(ctx_index("abs_mvd_greater0_flag"), int(ay > 0))
    if ax > 0:
        enc.encode_decision(ctx_index("abs_mvd_greater1_flag"), int(ax > 1))
    if ay > 0:
        enc.encode_decision(ctx_index("abs_mvd_greater1_flag"), int(ay > 1))
    for v, a in ((mx, ax), (my, ay)):
        if a > 0:
            if a > 1:
                enc.encode_egk_bypass(a - 2, 1)
            enc.encode_bypass(1 if v < 0 else 0)


def _write_intra_modes(ws: SliceWriteContext, cu):
    from turingcodec.decode.ctu_parse import _intra_mpm

    enc, plan, sps = ws.enc, ws.plan, ws.sps
    n = 4 if cu.part_mode == T.PART_NxN else 1
    pb = 1 << (cu.log2_size - (1 if n == 4 else 0))

    class _PS:  # adapter for _intra_mpm(ps, ...)
        pass
    ps = _PS()
    ps.plan = plan
    ps.geom = ws.geom
    ps.sps = sps

    modes = []
    cands_list = []
    for i in range(n):
        xb = cu.x0 + (i & 1) * pb
        yb = cu.y0 + (i >> 1) * pb
        modes.append(int(plan.intra_mode_y[yb >> 2, xb >> 2]))
        cands_list.append(_intra_mpm(ps, xb, yb))
    # NOTE: MPM candidates depend on neighbouring modes already *written*;
    # since the plan holds final modes and availability is decode-ordered,
    # derivation here matches the parser exactly.
    for i in range(n):
        enc.encode_decision(ctx_index("prev_intra_luma_pred_flag"),
                            int(modes[i] in cands_list[i]))
    for i in range(n):
        mode, cands = modes[i], cands_list[i]
        if mode in cands:
            idx = cands.index(mode)
            enc.encode_bypass(1 if idx else 0)
            if idx:
                enc.encode_bypass(idx - 1)
        else:
            rem = mode
            for c in sorted(cands, reverse=True):
                if rem > c:
                    rem -= 1
            enc.encode_bypass_bits(rem, 5)
    if sps.chroma_array_type in (1, 2):
        mode_c = int(plan.intra_mode_c[cu.y0 >> 2, cu.x0 >> 2])
        if mode_c == modes[0]:
            enc.encode_decision(ctx_index("intra_chroma_pred_mode"), 0)
        else:
            cand = [0, 26, 10, 1]
            eff = [34 if c == modes[0] else c for c in cand]
            idx = eff.index(mode_c)
            enc.encode_decision(ctx_index("intra_chroma_pred_mode"), 1)
            enc.encode_bypass_bits(idx, 2)


def write_transform_tree(ws: SliceWriteContext, x0, y0, x_base, y_base,
                         log2_size, trafo_depth, blk_idx, parent_cb, parent_cr):
    sps, pps, enc, plan, cu = ws.sps, ws.pps, ws.enc, ws.plan, ws.cu
    max_log2, min_log2 = sps.max_tb_log2_size_y, sps.min_tb_log2_size_y
    intra_split = cu.intra_split
    b = (y0 >> 2, x0 >> 2)
    split = int(plan.tu_log2[b]) < log2_size

    if (log2_size <= max_log2 and log2_size > min_log2
            and trafo_depth < cu.max_trafo_depth
            and not (intra_split and trafo_depth == 0)):
        enc.encode_decision(ctx_index("split_transform_flag", 5 - log2_size),
                            int(split))
    else:
        forced = (log2_size > max_log2 or (intra_split and trafo_depth == 0))
        assert split == forced or split, (split, forced, log2_size)
        split = forced or split

    chroma_here = log2_size > 2
    size = 1 << log2_size
    my_cb, my_cr = parent_cb, parent_cr
    if sps.chroma_array_type and chroma_here:
        # cbf of the chroma TB covering this node: any nonzero in the region
        cx0, cy0 = x0 >> 1, y0 >> 1
        cs = size >> 1
        my_cb = int(plan.coeff_cb[cy0:cy0 + cs, cx0:cx0 + cs].any())
        my_cr = int(plan.coeff_cr[cy0:cy0 + cs, cx0:cx0 + cs].any())
        if trafo_depth == 0 or parent_cb:
            enc.encode_decision(ctx_index("cbf_chroma", trafo_depth), my_cb)
        else:
            assert my_cb == 0
        if trafo_depth == 0 or parent_cr:
            enc.encode_decision(ctx_index("cbf_chroma", trafo_depth), my_cr)
        else:
            assert my_cr == 0

    if split:
        half = 1 << (log2_size - 1)
        for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half), (half, half))):
            write_transform_tree(ws, x0 + dx, y0 + dy, x0, y0,
                                 log2_size - 1, trafo_depth + 1, i,
                                 my_cb, my_cr)
        return

    cbf_luma = int(plan.coeff_y[y0:y0 + size, x0:x0 + size].any())
    if cu.pred_mode == 1 or trafo_depth != 0 or my_cb or my_cr:
        enc.encode_decision(
            ctx_index("cbf_luma", 1 if trafo_depth == 0 else 0), cbf_luma)
    else:
        assert cbf_luma == 1

    # transform_unit
    chroma_last = log2_size == 2 and blk_idx == 3
    any_chroma = (my_cb or my_cr) and (log2_size > 2 or chroma_last)
    # spec 7.3.8.10: the transform_unit body (cu_qp_delta included) runs
    # when ANY of cbf_luma/cbf_cb/cbf_cr is set — at 4x4 TUs the chroma
    # cbfs are the PARENT's, so the delta lands on blkIdx 0 of a
    # chroma-only group (reference-decoder cross-verified); the chroma
    # residual itself still rides blkIdx 3
    if cbf_luma or my_cb or my_cr:
        if pps.cu_qp_delta_enabled_flag and not ws.is_cu_qp_delta_coded:
            # derive the predictor the same way the parser does, then write
            # the delta that reproduces plan.qp_y
            from turingcodec.decode.ctu_parse import _derive_qp
            ws.cu_qp_delta_val = 0
            pred = _derive_qp(ws, cu.x0, cu.y0)
            val = int(plan.qp_y[cu.y0 >> 2, cu.x0 >> 2]) - pred
            ws.cu_qp_delta_val = val
            ws.is_cu_qp_delta_coded = True
            a = abs(val)
            # cu_qp_delta_abs: TR prefix (cMax 5, ctx [0,1,1,1,1]), EG0 tail
            for k in range(min(a, 5)):
                enc.encode_decision(
                    ctx_index("cu_qp_delta_abs", 0 if k == 0 else 1), 1)
            if a < 5:
                enc.encode_decision(
                    ctx_index("cu_qp_delta_abs", 0 if a == 0 else 1), 0)
            else:
                enc.encode_egk_bypass(a - 5, 0)
            if a:
                enc.encode_bypass(1 if val < 0 else 0)
        if cbf_luma:
            write_residual(ws, x0, y0, log2_size, 0)
        if any_chroma:
            if log2_size > 2:
                if my_cb:
                    write_residual(ws, x0 >> 1, y0 >> 1, log2_size - 1, 1)
                if my_cr:
                    write_residual(ws, x0 >> 1, y0 >> 1, log2_size - 1, 2)
            else:
                cbx, cby = x_base >> 1, y_base >> 1
                if my_cb:
                    write_residual(ws, cbx, cby, 2, 1)
                if my_cr:
                    write_residual(ws, cbx, cby, 2, 2)


def write_residual(ws: SliceWriteContext, x0, y0, log2_size, c_idx):
    """residual_coding() writing — exact inverse of parse_residual_coding."""
    sps, pps, enc, plan, cu = ws.sps, ws.pps, ws.enc, ws.plan, ws.cu

    if c_idx == 0:
        coeff_plane = plan.coeff_y
    elif c_idx == 1:
        coeff_plane = plan.coeff_cb
    else:
        coeff_plane = plan.coeff_cr
    n = 1 << log2_size
    blk = coeff_plane[y0:y0 + n, x0:x0 + n]
    assert blk.any(), "write_residual on all-zero block"

    if (pps.transform_skip_enabled_flag and not cu.tq_bypass and log2_size == 2):
        el = ("transform_skip_flag_luma" if c_idx == 0
              else "transform_skip_flag_chroma")
        ts = int((plan.transform_skip_y if c_idx == 0 else
                  (plan.transform_skip_cb if c_idx == 1 else
                   plan.transform_skip_cr))[
                      (y0 >> 2, x0 >> 2) if c_idx == 0 else (y0 >> 1, x0 >> 1)])
        enc.encode_decision(ctx_index(el), ts)

    # scan selection — same rule as parse
    scan_idx = 0
    if cu.pred_mode == 1 and (log2_size == 2 or (log2_size == 3 and c_idx == 0)):
        if c_idx == 0:
            mode = int(plan.intra_mode_y[y0 >> 2, x0 >> 2])
        else:
            mode = int(plan.intra_mode_c[(y0 << 1) >> 2, (x0 << 1) >> 2])
        if 6 <= mode <= 14:
            scan_idx = 2
        elif 22 <= mode <= 30:
            scan_idx = 1

    residual_core(enc, blk, log2_size, c_idx, scan_idx,
                  pps.sign_data_hiding_enabled_flag and not cu.tq_bypass)


def residual_core(enc, blk, log2_size, c_idx, scan_idx, sdh):
    """Core residual_coding bin production from an explicit coefficient
    block. `enc` is a CabacEncoder or cabac.rate.RateEstimator."""
    sub_scan = _scan(log2_size - 2, scan_idx)
    pos_scan = _scan(2, scan_idx)
    n_sub = 1 << (2 * (log2_size - 2))
    nsb = 1 << (log2_size - 2)

    # subblock-major scan view: coefs[ys][xs][nn] = value at scan pos nn
    v4 = np.asarray(blk).reshape(nsb, 4, nsb, 4).transpose(0, 2, 1, 3)
    coef = v4[:, :, pos_scan[:, 1], pos_scan[:, 0]]        # (nsb, nsb, 16)
    coefs = coef.tolist()
    sub_xy = sub_scan[:, :2].tolist()

    # locate last significant coefficient in scan order: the highest-scan
    # position of the highest non-empty subblock
    last_i = -1
    last_n = -1
    for i in range(n_sub - 1, -1, -1):
        xs, ys = sub_xy[i]
        row = coefs[ys][xs]
        for nn in range(15, -1, -1):
            if row[nn]:
                last_i, last_n = i, nn
                break
        if last_i >= 0:
            break
    assert last_i >= 0
    xs, ys = sub_xy[last_i]
    last_x = (xs << 2) + int(pos_scan[last_n, 0])
    last_y = (ys << 2) + int(pos_scan[last_n, 1])

    wx, wy = (last_y, last_x) if scan_idx == 2 else (last_x, last_y)

    def write_last_prefix(element, v):
        c_max = (log2_size << 1) - 1
        if v > 3:
            prefix = (v >= 2) and 0
            # prefix p such that v in [ (2+(p&1)) << ((p>>1)-1), ... )
            p = 0
            while p < c_max:
                if p <= 3:
                    lo, hi = p, p
                else:
                    k = (p >> 1) - 1
                    lo = (2 + (p & 1)) << k
                    hi = lo + (1 << k) - 1
                if lo <= v <= hi:
                    break
                p += 1
            prefix = p
        else:
            prefix = v
        if c_idx == 0:
            ctx_off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
            ctx_shift = (log2_size + 1) >> 2
        else:
            ctx_off = 15
            ctx_shift = log2_size - 2
        for k in range(prefix):
            enc.encode_decision(
                ctx_index(element, (k >> ctx_shift) + ctx_off), 1)
        if prefix < c_max:
            enc.encode_decision(
                ctx_index(element, (prefix >> ctx_shift) + ctx_off), 0)
        return prefix

    px = write_last_prefix("last_sig_coeff_x_prefix", wx)
    py = write_last_prefix("last_sig_coeff_y_prefix", wy)
    if px > 3:
        nbits = (px >> 1) - 1
        enc.encode_bypass_bits(wx - ((2 + (px & 1)) << nbits), nbits)
    if py > 3:
        nbits = (py >> 1) - 1
        enc.encode_bypass_bits(wy - ((2 + (py & 1)) << nbits), nbits)

    csbf = (coef != 0).any(axis=2).astype(np.uint8)    # [ys, xs]

    c1_chain_gt1 = 0
    sub_of_last = last_i
    pos_of_last = last_n

    for i in range(sub_of_last, -1, -1):
        xs, ys = sub_xy[i]
        sb_coded = int(csbf[ys, xs])
        infer_sb_dc = 0
        if i < sub_of_last and i > 0:
            inc = int(bool((xs + 1 < nsb and csbf[ys, xs + 1])
                           or (ys + 1 < nsb and csbf[ys + 1, xs])))
            enc.encode_decision(
                ctx_index("coded_sub_block_flag", inc + (2 if c_idx else 0)),
                sb_coded)
            infer_sb_dc = 1
        else:
            # subblock 0 and the last subblock are inferred coded: even an
            # all-zero DC subblock emits its (all-zero) sig flags
            sb_coded = 1
            csbf[ys, xs] = 1
        if not sb_coded:
            continue

        levels = coefs[ys][xs]
        sig = [1 if v else 0 for v in levels]
        start_n = pos_of_last - 1 if i == sub_of_last else 15
        prev_csbf = 0
        if xs + 1 < nsb and csbf[ys, xs + 1]:
            prev_csbf += 1
        if ys + 1 < nsb and csbf[ys + 1, xs]:
            prev_csbf += 2
        sctx16 = _sig_ctx16(log2_size, c_idx, scan_idx, xs, ys, prev_csbf)
        for nn in range(start_n, -1, -1):
            if nn > 0 or not infer_sb_dc:
                enc.encode_decision(sctx16[nn], sig[nn])
                if sig[nn]:
                    infer_sb_dc = 0
            else:
                assert sig[nn] == 1, "SDH/infer constraint violated"

        sig_pos = [nn for nn in range(15, -1, -1) if sig[nn]]
        if not sig_pos:
            continue

        ctx_set = (0 if (i == 0 or c_idx > 0) else 2) + (1 if c1_chain_gt1 else 0)
        c1 = 1
        c1_chain_gt1 = 0
        gt1 = {}
        first_gt1_pos = -1
        for k, nn in enumerate(sig_pos[:8]):
            g = int(abs(levels[nn]) > 1)
            enc.encode_decision(
                ctx_index("coeff_abs_level_greater1_flag",
                          ctx_set * 4 + c1 + (16 if c_idx else 0)), g)
            gt1[nn] = g
            if g:
                c1 = 0
                c1_chain_gt1 = 1
                if first_gt1_pos < 0:
                    first_gt1_pos = nn
            elif 0 < c1 < 3:
                c1 += 1
        gt2 = {}
        if first_gt1_pos >= 0:
            g2 = int(abs(levels[first_gt1_pos]) > 2)
            enc.encode_decision(
                ctx_index("coeff_abs_level_greater2_flag",
                          ctx_set + (4 if c_idx else 0)), g2)
            gt2[first_gt1_pos] = g2

        first_sig_scan = sig_pos[-1]
        last_sig_scan = sig_pos[0]
        sign_hidden = sdh and (last_sig_scan - first_sig_scan > 3)
        if sign_hidden:
            total = sum(abs(levels[nn]) for nn in sig_pos)
            assert (total & 1) == (1 if levels[first_sig_scan] < 0 else 0), \
                "encoder must enforce SDH parity before writing"
        for nn in sig_pos:
            if sign_hidden and nn == first_sig_scan:
                continue
            enc.encode_bypass(1 if levels[nn] < 0 else 0)

        rice = 0
        for k, nn in enumerate(sig_pos):
            a = abs(levels[nn])
            base = 1
            if k < 8:
                base += gt1.get(nn, 0)
                if nn == first_gt1_pos:
                    base += gt2.get(nn, 0)
            need_rem = False
            if k < 8:
                if nn == first_gt1_pos and gt2.get(nn, 0):
                    need_rem = True
                elif gt1.get(nn, 0) and nn != first_gt1_pos:
                    need_rem = True
            else:
                need_rem = True
            if need_rem:
                _write_remaining(enc, a - base, rice)
                if a > (3 << rice):
                    rice = min(rice + 1, 4)
            else:
                assert a == base, (a, base, k, nn)


def _write_remaining(enc: CabacEncoder, value: int, rice: int):
    """coeff_abs_level_remaining binarization (inverse of _decode_remaining)."""
    if (value >> rice) <= 3:
        prefix = value >> rice
        for _ in range(prefix):
            enc.encode_bypass(1)
        enc.encode_bypass(0)
        if rice:
            enc.encode_bypass_bits(value & ((1 << rice) - 1), rice)
    else:
        # escape: find prefix >= 4 (wait: prefix > 3) such that value fits
        prefix = 4
        while True:
            base = ((1 << (prefix - 3)) + 2) << rice
            nbits = prefix - 3 + rice
            if value < base + (1 << nbits):
                break
            prefix += 1
        for _ in range(prefix):
            enc.encode_bypass(1)
        enc.encode_bypass(0)
        enc.encode_bypass_bits(value - base, prefix - 3 + rice)
