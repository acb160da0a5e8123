"""Decoded picture buffer: POC derivation, reference picture set marking,
reference list construction, output (bumping) process.

Spec 8.3.1 (POC), 8.3.2 (RPS), 8.3.4 (ref lists), C.5.2 (bumping).
Parity reference: turing/StatePictures.h:92-99 (POC lists), 220 (DPB ops),
443-521 (RefPicList construction), 701 (bumping).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from turingcodec.hevc import types as T
from turingcodec.hevc.params import SliceSegmentHeader, Sps


@dataclass
class DecodedPicture:
    poc: int
    planes: list = None            # [y, cb, cr] int16 numpy (reconstructed)
    plan = None                    # PicturePlan (motion field for TMVP)
    is_reference: bool = True
    is_long_term: bool = False
    needed_for_output: bool = True
    output_order: int = 0
    temporal_id: int = 0
    nal_unit_type: int = 0
    pic_latency_count: int = 0


class Dpb:
    """Decoded picture buffer + POC state machine."""

    def __init__(self, sps: Sps):
        self.sps = sps
        self.pics: List[DecodedPicture] = []
        self.prev_tid0_poc = 0
        self.poc = 0
        # current picture's reference sets (filled by start_picture)
        self.ref_pic_list = [[], []]   # [l0, l1] of DecodedPicture
        self.st_curr_before: List[DecodedPicture] = []
        self.st_curr_after: List[DecodedPicture] = []
        self.lt_curr: List[DecodedPicture] = []
        self.output_queue: List[DecodedPicture] = []

    # ---------------- POC (spec 8.3.1) ----------------
    def derive_poc(self, sh: SliceSegmentHeader, first_pic: bool) -> int:
        sps = self.sps
        nut = sh.nal_unit_type
        if T.is_idr(nut):
            poc = 0
        else:
            max_lsb = sps.max_pic_order_cnt_lsb
            prev_lsb = self.prev_tid0_poc % max_lsb
            prev_msb = self.prev_tid0_poc - prev_lsb
            lsb = sh.slice_pic_order_cnt_lsb
            if T.is_irap(nut) and first_pic:
                msb = 0
            elif lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            poc = msb + lsb
        if sh.temporal_id == 0 and not T.is_rasl(nut) and not T.is_radl(nut) \
                and not T.is_sub_layer_non_reference(nut):
            self.prev_tid0_poc = poc
        self.poc = poc
        return poc

    # ---------------- RPS application (spec 8.3.2) ----------------
    def apply_rps(self, sh: SliceSegmentHeader, poc: int):
        sps = self.sps
        from turingcodec.hevc.header_syntax import _active_rps
        if T.is_idr(sh.nal_unit_type):
            for p in self.pics:
                p.is_reference = False
            self.st_curr_before = []
            self.st_curr_after = []
            self.lt_curr = []
            return
        rps = _active_rps(sh, sps)
        poc_st_curr_before, poc_st_curr_after, poc_st_foll = [], [], []
        for d, used in zip(rps.delta_poc_s0, rps.used_s0):
            (poc_st_curr_before if used else poc_st_foll).append(poc + d)
        for d, used in zip(rps.delta_poc_s1, rps.used_s1):
            (poc_st_curr_after if used else poc_st_foll).append(poc + d)
        # long-term
        poc_lt_curr, poc_lt_foll = [], []
        lt_has_msb = []
        max_lsb = sps.max_pic_order_cnt_lsb
        for (lsb, used, msb_p, msb_c) in sh.long_term_pics:
            if msb_p:
                lt_poc = poc - msb_c * max_lsb - (poc % max_lsb) + lsb
            else:
                lt_poc = lsb
            (poc_lt_curr if used else poc_lt_foll).append((lt_poc, msb_p))

        def find(target_poc, lsb_only=False):
            # spec 8.3.2: RPS derivation matches pictures marked "used for
            # reference" — pictures lingering only for output (e.g. the
            # previous CVS's, after a mid-stream IDR) can collide on POC
            # and must not be picked up
            for p in self.pics:
                if not p.is_reference:
                    continue
                if lsb_only:
                    if p.poc % max_lsb == target_poc:
                        return p
                elif p.poc == target_poc:
                    return p
            return None

        self.st_curr_before = []
        self.st_curr_after = []
        self.lt_curr = []
        keep_ref = set()
        for tp in poc_st_curr_before:
            p = find(tp)
            self.st_curr_before.append(p)
            if p:
                keep_ref.add(id(p))
                p.is_long_term = False
        for tp in poc_st_curr_after:
            p = find(tp)
            self.st_curr_after.append(p)
            if p:
                keep_ref.add(id(p))
                p.is_long_term = False
        for tp in poc_st_foll:
            p = find(tp)
            if p:
                keep_ref.add(id(p))
                p.is_long_term = False
        for (tp, has_msb) in poc_lt_curr:
            p = find(tp, lsb_only=not has_msb)
            self.lt_curr.append(p)
            if p:
                keep_ref.add(id(p))
                p.is_long_term = True
        for (tp, has_msb) in poc_lt_foll:
            p = find(tp, lsb_only=not has_msb)
            if p:
                keep_ref.add(id(p))
                p.is_long_term = True
        for p in self.pics:
            if id(p) not in keep_ref:
                p.is_reference = False

    # ---------------- ref lists (spec 8.3.4) ----------------
    def build_ref_lists(self, sh: SliceSegmentHeader):
        self.ref_pic_list = [[], []]
        if sh.is_i:
            return
        from turingcodec.decode.violations import Violation
        n0 = sh.num_ref_idx_l0_active_minus1 + 1
        tmp0 = self.st_curr_before + self.st_curr_after + self.lt_curr
        if not tmp0 or any(p is None for p in tmp0):
            raise Violation("8.3.2", "RPS names a picture that is not in "
                            "the DPB (missing reference picture)")
        while len(tmp0) < n0:
            tmp0 = tmp0 + tmp0  # repeat until long enough
        if sh.ref_pic_list_modification_flag_l0:
            l0 = [tmp0[i] for i in sh.list_entry_l0]
        else:
            l0 = tmp0[:n0]
        self.ref_pic_list[0] = l0[:n0]
        if sh.is_b:
            n1 = sh.num_ref_idx_l1_active_minus1 + 1
            tmp1 = self.st_curr_after + self.st_curr_before + self.lt_curr
            while len(tmp1) < n1:
                tmp1 = tmp1 + tmp1
            if sh.ref_pic_list_modification_flag_l1:
                l1 = [tmp1[i] for i in sh.list_entry_l1]
            else:
                l1 = tmp1[:n1]
            self.ref_pic_list[1] = l1[:n1]

    # ---------------- output / bumping (spec C.5.2) ----------------
    def _bump_one(self) -> Optional[DecodedPicture]:
        cands = [p for p in self.pics if p.needed_for_output]
        if not cands:
            return None
        p = min(cands, key=lambda q: q.poc)
        p.needed_for_output = False
        if not p.is_reference:
            self.pics.remove(p)
        return p

    def picture_done(self, pic: DecodedPicture, sh: SliceSegmentHeader) -> List[DecodedPicture]:
        """Insert the finished picture and emit any output pictures, in order."""
        out = []
        sps = self.sps
        max_reorder = sps.sps_max_num_reorder_pics[-1]
        max_dpb = sps.sps_max_dec_pic_buffering_minus1[-1] + 1
        if T.is_irap(sh.nal_unit_type) and not T.is_idr(sh.nal_unit_type):
            pass  # CRA/BLA no_output handling (CRA as first pic: output ok)
        # remove non-reference non-output pics
        self.pics = [p for p in self.pics
                     if p.is_reference or p.needed_for_output]
        pic.needed_for_output = bool(sh.pic_output_flag)
        self.pics.append(pic)
        while True:
            waiting = [p for p in self.pics if p.needed_for_output]
            if len(waiting) > max_reorder or len(self.pics) > max_dpb:
                p = self._bump_one()
                if p is None:
                    break
                out.append(p)
            else:
                break
        return out

    def flush(self) -> List[DecodedPicture]:
        out = []
        while True:
            p = self._bump_one()
            if p is None:
                break
            out.append(p)
        self.pics = []
        return out
