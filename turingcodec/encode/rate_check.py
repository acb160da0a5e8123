"""The checkRate invariant (turing/Write.h:715-726,820-826 analogue):
re-walk the final PicturePlan with the writer's own bin production driving
a RateEstimator instead of the arithmetic coder, and return the exact
fractional bits per CTU. The search's committed per-CTU rate
(IntraPictureEncoder._ctu_frac / native cur.ctu_frac) must equal this
integer-exactly — every mode bin and residual bin the search accounted
for is exactly what the writer will produce, with the same context states.

SAO bins and end_of_*_one_bit terminates are outside the search's cost
model (SAO is estimated separately after the picture) — callers verify on
SAO-less configurations.
"""
from __future__ import annotations

from typing import List

from turingcodec.cabac.rate import RateEstimator
from turingcodec.encode.ctu_write import SliceWriteContext, write_ctu
from turingcodec.hevc.geometry import PictureGeometry
from turingcodec.hevc.params import SliceSegmentHeader
from turingcodec.decode.plan import PicturePlan


def writer_walk_frac(plan: PicturePlan, geom: PictureGeometry,
                     sh: SliceSegmentHeader, slice_number: int = 0
                     ) -> List[int]:
    """Exact fractional bits (1/256 units) of each CTU's bins, in the
    writer's order and context chain (WPP inheritance / tile resets
    mirrored from ctu_write.write_slice_data)."""
    sps, pps = plan.sps, plan.pps
    assert not (sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag), \
        "rate invariant is checked on SAO-less configurations"
    wc = sps.pic_width_in_ctbs_y
    wpp = bool(pps.entropy_coding_sync_enabled_flag)
    ws = SliceWriteContext(plan, geom, sh, slice_number)
    ws.enc = RateEstimator(ws.ctx)
    snap_rx = 1 if wc > 1 else 0
    n_ctus = geom.wc * geom.hc
    start_ts = int(geom.rs_to_ts[sh.slice_segment_address])
    tiles = bool(pps.tiles_enabled_flag)
    out = []
    for ctb_addr_ts in range(start_ts, n_ctus):
        ctb_addr_rs = geom.tile_scan_ctus[ctb_addr_ts]
        rx, ry = ctb_addr_rs % wc, ctb_addr_rs // wc
        if tiles and ctb_addr_ts > start_ts:
            prev_rs = geom.tile_scan_ctus[ctb_addr_ts - 1]
            if geom.tile_id[ry, rx] != geom.tile_id[prev_rs // wc,
                                                    prev_rs % wc]:
                ws.ctx.initialize(sh.init_type(), sh.slice_qp_y)
                ws.qp_y_pred = sh.slice_qp_y
                ws.last_cu_qp = sh.slice_qp_y
        if wpp and rx == 0 and ctb_addr_ts > start_ts:
            up_ok = (ws.wpp_saved_ctx is not None
                     and plan.slice_idx[ry - 1, min(1, wc - 1)]
                     == slice_number)
            if up_ok:
                ws.ctx.states = bytearray(ws.wpp_saved_ctx.states)
            else:
                ws.ctx.initialize(sh.init_type(), sh.slice_qp_y)
            ws.qp_y_pred = sh.slice_qp_y
            ws.last_cu_qp = sh.slice_qp_y
        before = ws.enc.frac_bits
        write_ctu(ws, ctb_addr_rs)
        out.append(ws.enc.frac_bits - before)
        if wpp and rx == snap_rx:
            ws.wpp_saved_ctx = ws.ctx.copy()
    return out
