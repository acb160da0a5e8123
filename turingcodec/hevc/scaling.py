"""Scaling list -> ScalingFactor matrices (spec 7.4.5 / 8.6.3)."""
from __future__ import annotations

import numpy as np

from turingcodec.hevc.tables import default_scaling_list, diag_scan_order


def build_scaling_factors(sld=None):
    """Returns {(log2_size, matrix_id): (N, N) int array m[y][x]}.

    matrix_id: 0..5 (sizeId<3), 0/3 used for sizeId 3 (32x32); callers pass
    intra Y/Cb/Cr = 0/1/2, inter Y/Cb/Cr = 3/4/5 (32x32 chroma unused in 4:2:0).
    """
    out = {}
    for size_id in range(4):
        n = 4 << size_id
        log2 = size_id + 2
        for matrix_id in range(6):
            if size_id == 3 and matrix_id % 3 != 0:
                # 32x32 has only intra (0) and inter (3) lists
                src_m = matrix_id - (matrix_id % 3)
            else:
                src_m = matrix_id
            if sld is not None and sld.lists[size_id][src_m] is not None:
                lst = sld.lists[size_id][src_m]
                dc = sld.dc[size_id - 2][src_m] if size_id > 1 else None
            else:
                lst = default_scaling_list(min(size_id, 1) if size_id == 0 else (1 if size_id else 0), src_m)
                lst = default_scaling_list(size_id, src_m)
                dc = 16 if size_id > 1 else None
            m = np.zeros((n, n), np.int32)
            if size_id == 0:
                scan = diag_scan_order(2)
                for i, (x, y) in enumerate(scan):
                    m[y, x] = lst[i]
            else:
                # 8x8 list upsampled to n (spec 7.4.5): blocks of n/8
                scan = diag_scan_order(3)
                base = np.zeros((8, 8), np.int32)
                for i, (x, y) in enumerate(scan):
                    base[y, x] = lst[i]
                k = n // 8
                m = np.kron(base, np.ones((k, k), np.int32))
                if dc is not None and size_id > 1:
                    m[0, 0] = dc
            out[(log2, matrix_id)] = m
    return out
