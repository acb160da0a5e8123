"""Picture geometry: tile maps, z-scan addresses, availability (spec 6.4/6.5).

Everything here is a pure function of SPS/PPS — computed once per sequence as
dense numpy tables (the reference computes the same maps in Global.h derived
values / turing/StateSpatial.h; availability there is tracked by pointer
snakes, here by geometric z-order comparison, which is equivalent because
decode order == z-order).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from turingcodec.hevc.params import Pps, Sps


def z_order_in_ctu(n: int) -> np.ndarray:
    """(n, n) table: z (Morton) index of block (y, x) within a CTU grid."""
    idx = np.zeros((n, n), dtype=np.int32)
    for y in range(n):
        for x in range(n):
            z = 0
            for b in range(16):
                z |= ((x >> b) & 1) << (2 * b)
                z |= ((y >> b) & 1) << (2 * b + 1)
            idx[y, x] = z
    return idx


@dataclass
class PictureGeometry:
    sps: Sps
    pps: Pps

    def __post_init__(self):
        sps, pps = self.sps, self.pps
        self.wc = sps.pic_width_in_ctbs_y
        self.hc = sps.pic_height_in_ctbs_y
        self.ctb_log2 = sps.ctb_log2_size_y
        self.blocks_per_ctu_side = 1 << (self.ctb_log2 - 2)
        n = self.blocks_per_ctu_side

        # tile id per CTU (raster addressed)
        col_bd = pps.tile_column_boundaries(sps)
        row_bd = pps.tile_row_boundaries(sps)
        self.tile_id = np.zeros((self.hc, self.wc), dtype=np.int32)
        tid = 0
        self.tile_scan_ctus = []  # CtbAddrTs -> CtbAddrRs
        for tr in range(len(row_bd) - 1):
            for tc in range(len(col_bd) - 1):
                for y in range(row_bd[tr], row_bd[tr + 1]):
                    for x in range(col_bd[tc], col_bd[tc + 1]):
                        self.tile_id[y, x] = tid
                        self.tile_scan_ctus.append(y * self.wc + x)
                tid += 1
        self.num_tiles = tid
        # CtbAddrRsToTs
        self.rs_to_ts = np.zeros(self.hc * self.wc, dtype=np.int32)
        for ts, rs in enumerate(self.tile_scan_ctus):
            self.rs_to_ts[rs] = ts

        # z-scan address per 4x4 block over whole picture (spec 6.5.2:
        # MinTbAddrZs but at min-block granularity): CTU tile-scan index
        # shifted, plus Morton index inside the CTU.
        w4 = sps.pic_width_in_luma_samples // 4
        h4 = sps.pic_height_in_luma_samples // 4
        self.w4, self.h4 = w4, h4
        zin = z_order_in_ctu(n)
        self.zscan = np.zeros((h4, w4), dtype=np.int64)
        for cy in range(self.hc):
            for cx in range(self.wc):
                ts = self.rs_to_ts[cy * self.wc + cx]
                base = int(ts) << (2 * (self.ctb_log2 - 2))
                y0, x0 = cy * n, cx * n
                y1 = min(y0 + n, h4)
                x1 = min(x0 + n, w4)
                self.zscan[y0:y1, x0:x1] = base + zin[: y1 - y0, : x1 - x0]

    def available(self, slice_idx_map: np.ndarray,
                  x_curr: int, y_curr: int, x_nb: int, y_nb: int) -> bool:
        """Z-scan-order availability (spec 6.4.1). Coordinates in luma samples.

        slice_idx_map: per-CTU slice index (-1 = not yet decoded).
        """
        if x_nb < 0 or y_nb < 0:
            return False
        if x_nb >= self.sps.pic_width_in_luma_samples:
            return False
        if y_nb >= self.sps.pic_height_in_luma_samples:
            return False
        # plain-list zscan: ~3x cheaper than numpy scalar indexing in this
        # per-neighbour hot path
        zs = getattr(self, "_zs_list", None)
        if zs is None:
            zs = self._zs_list = self.zscan.tolist()
        if zs[y_nb >> 2][x_nb >> 2] > zs[y_curr >> 2][x_curr >> 2]:
            return False
        cs = slice_idx_map[y_curr >> self.ctb_log2, x_curr >> self.ctb_log2]
        ns = slice_idx_map[y_nb >> self.ctb_log2, x_nb >> self.ctb_log2]
        if cs != ns:
            return False
        if (self.tile_id[y_nb >> self.ctb_log2, x_nb >> self.ctb_log2]
                != self.tile_id[y_curr >> self.ctb_log2, x_curr >> self.ctb_log2]):
            return False
        return True
