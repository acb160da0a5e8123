"""slice_segment_data() driver: CTU loop with WPP/tile substream handling
(spec 7.3.8.1, 9.3.1 init/sync).

Parity reference: turing/SyntaxRbsp.hpp:852-877 (the per-CTU loop), Read.h
CabacRestart (Read.h:100-116) and the rewind identity at terminate bins.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from turingcodec.bitstream.reader import BitReader
from turingcodec.cabac.engine import CabacDecoder, ContextPool
from turingcodec.decode.ctu_parse import SliceParseContext, parse_ctu
from turingcodec.hevc.geometry import PictureGeometry
from turingcodec.hevc.params import SliceSegmentHeader


def parse_slice_segment_data(plan, geom: PictureGeometry,
                             sh: SliceSegmentHeader, rbsp: bytes,
                             data_bit_pos: int, slice_number: int,
                             inter_hook=None, dss_state=None):
    """Parse all CTUs of one slice segment into the plan.

    data_bit_pos: bit offset in rbsp where slice data starts (byte aligned).
    dss_state: (ContextPool, last_cu_qp) saved at the end of the previous
    segment — applied when this is a dependent slice segment (spec 9.3.1
    context continuation; qPY_PREV carries across segment boundaries).
    Returns the same pair for a possible following dependent segment.
    """
    sps, pps = plan.sps, plan.pps
    wc = sps.pic_width_in_ctbs_y
    wpp = bool(pps.entropy_coding_sync_enabled_flag)

    ps = SliceParseContext(plan, geom, sh, slice_number, inter_hook)
    # native (C++) full-CTU parse covers the common case; None -> pure Python
    from turingcodec.native import SliceNative
    nat = SliceNative.try_create(plan, geom, sh, slice_number, inter_hook)
    if dss_state is not None and sh.dependent_slice_segment_flag:
        ps.ctx.states = bytearray(dss_state[0].states)
        ps.last_cu_qp = dss_state[1]
        ps.qp_y_pred = dss_state[1]
    else:
        ps.ctx.initialize(sh.init_type(), sh.slice_qp_y)

    assert data_bit_pos % 8 == 0
    ps.dec = CabacDecoder(rbsp, data_bit_pos, ps.ctx)

    ctb_addr_ts = int(geom.rs_to_ts[sh.slice_segment_address])
    snap_rx = 1 if wc > 1 else 0

    if nat is not None:
        # whole-slice native loop (WPP/tile substreams handled inside)
        nat.parse_slice(ps, geom, sh, ctb_addr_ts)
        nat.finish()
        return ps.ctx.copy(), ps.last_cu_qp

    while True:
        ctb_addr_rs = geom.tile_scan_ctus[ctb_addr_ts]
        rx, ry = ctb_addr_rs % wc, ctb_addr_rs // wc

        # WPP row start: inherit contexts from above-right CTU's snapshot
        if wpp and rx == 0 and ry > 0 and ctb_addr_ts > 0:
            x0l, y0l = rx << sps.ctb_log2_size_y, ry << sps.ctb_log2_size_y
            ctb = 1 << sps.ctb_log2_size_y
            # availability of CTU (1, ry-1): must already be decoded in the
            # same slice+tile (checked via the slice map which parse fills)
            up_right_ok = (
                ps.wpp_saved_ctx is not None
                and plan.slice_idx[ry - 1, min(1, wc - 1)] == slice_number
                and geom.tile_id[ry - 1, min(1, wc - 1)] == geom.tile_id[ry, rx])
            if up_right_ok:
                ps.ctx.states = bytearray(ps.wpp_saved_ctx.states)
            else:
                ps.ctx.initialize(sh.init_type(), sh.slice_qp_y)
            ps.qp_y_pred = sh.slice_qp_y
            ps.last_cu_qp = sh.slice_qp_y

        # tile start: re-init contexts
        if ctb_addr_ts > 0 and not (wpp and rx == 0):
            prev_rs = geom.tile_scan_ctus[ctb_addr_ts - 1]
            if geom.tile_id[ry, rx] != geom.tile_id[
                    prev_rs // wc, prev_rs % wc]:
                ps.ctx.initialize(sh.init_type(), sh.slice_qp_y)
                ps.qp_y_pred = sh.slice_qp_y
                ps.last_cu_qp = sh.slice_qp_y

        if nat is not None:
            nat.parse_ctu(ps, ctb_addr_rs)
        else:
            parse_ctu(ps, ctb_addr_rs)

        if wpp and rx == snap_rx:
            ps.wpp_saved_ctx = ps.ctx.copy()

        end_of_slice = ps.dec.decode_terminate()
        ctb_addr_ts += 1
        if end_of_slice:
            break
        if ctb_addr_ts >= geom.wc * geom.hc:
            raise ValueError("slice data overruns picture")

        next_rs = geom.tile_scan_ctus[ctb_addr_ts]
        new_tile = geom.tile_id[next_rs // wc, next_rs % wc] != geom.tile_id[ry, rx]
        new_row = wpp and (next_rs % wc == 0)
        if (pps.tiles_enabled_flag and new_tile) or new_row:
            # end_of_subset_one_bit (terminate, == 1) + byte alignment, then
            # the engine restarts at the next byte boundary
            eos = ps.dec.decode_terminate()
            assert eos == 1, "end_of_subset_one_bit must be 1"
            br = BitReader(rbsp)
            br.pos = ps.dec.pos - 1
            br.byte_alignment()
            ps.dec = CabacDecoder(rbsp, br.pos, ps.ctx)

    if nat is not None:
        nat.finish()
    return ps.ctx.copy(), ps.last_cu_qp
