"""HM-style rate-distortion optimized quantization.

Parity reference: turing/Rdoq.cpp:35-444 (runQuantisation) — per-coefficient
level adjustment against context-exact CABAC rate estimates, 4x4
coefficient-group zeroing decisions, and an RD-optimal last-significant-
position sweep. This is the Python oracle of the native twin
(native/enc_core.cpp rdoq_quantize); both read (never mutate) the search's
rate-context pool and produce identical levels (double arithmetic mirrored
operation for operation).

Rates are in 1/256-bit units (cabac.rate.BITS); costs are
err^2 * 2^-(2*transformShift + 2*(bd-8)) + lambda * bits.
"""
from __future__ import annotations

import math

import numpy as np

from turingcodec.cabac.engine import ctx_index
from turingcodec.cabac.rate import _BITS_L
from turingcodec.hevc.tables import LEVEL_SCALE, QUANT_SCALES

_BLEN = [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
         8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9]

_SIG4 = [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8]


def _sig_ctx(log2, c_idx, scan_idx, xc, yc, prev_csbf):
    if log2 == 2:
        sig = _SIG4[((yc & 3) << 2) + (xc & 3)]
    elif xc == 0 and yc == 0:
        sig = 0
    else:
        xp, yp = xc & 3, yc & 3
        if prev_csbf == 0:
            s = xp + yp
            sig = 2 if s == 0 else (1 if s < 3 else 0)
        elif prev_csbf == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev_csbf == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if c_idx == 0:
            if (xc >> 2) or (yc >> 2):
                sig += 3
            sig += 9 if (log2 == 3 and scan_idx == 0) else (
                15 if log2 == 3 else 21)
        else:
            sig += 9 if log2 == 3 else 12
    return sig + (27 if c_idx else 0)


def rdoq_quantize(coeffs, qp, bd, log2, c_idx, scan_idx, cbf_ctx_abs,
                  states, lam):
    """Returns int32 levels array (signed), shaped like coeffs."""
    from turingcodec.decode.ctu_parse import _scan

    n = 1 << log2
    count = n * n
    ts = 15 - bd - log2
    err_scale = math.ldexp(1.0, -(2 * ts + 2 * (bd - 8)))
    q_shift = 14 + qp // 6 + ts
    q_scale = int(QUANT_SCALES[qp % 6])
    inv_scale = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    inv_shift = bd + log2 - 9
    inv_offset = 1 << (inv_shift - 1)
    g1_off = ctx_index("coeff_abs_level_greater1_flag") + (16 if c_idx else 0)
    g2_off = ctx_index("coeff_abs_level_greater2_flag") + (4 if c_idx else 0)
    off_sig = ctx_index("sig_coeff_flag")
    off_csbf = ctx_index("coded_sub_block_flag")
    off_lastx = ctx_index("last_sig_coeff_x_prefix")
    off_lasty = ctx_index("last_sig_coeff_y_prefix")
    cg_scan = _scan(log2 - 2, scan_idx)
    in_scan = _scan(2, scan_idx)
    total_cg = count >> 4
    cgw = 1 << (log2 - 2)

    def est(idx, binv):
        return _BITS_L[states[idx]][binv]

    def level_cost(level, g1_ctx, g2_ctx, rice, g1_cnt, g2_cnt):
        rate = 256
        base = (2 + (1 if g2_cnt < 1 else 0)) if g1_cnt < 8 else 1
        if level >= base:
            symbol = level - base
            if symbol < (3 << rice):
                rate += ((symbol >> rice) + 1 + rice) << 8
            else:
                length = rice
                symbol -= 3 << rice
                while symbol >= (1 << length):
                    symbol -= 1 << length
                    length += 1
                rate += (3 + length + 1 - rice + length) << 8
            if g1_cnt < 8:
                rate += est(g1_ctx, 1)
                if g2_cnt < 1:
                    rate += est(g2_ctx, 1)
        elif level == 1:
            rate += est(g1_ctx, 0)
        elif level == 2:
            rate += est(g1_ctx, 1)
            rate += est(g2_ctx, 0)
        return lam * (float(rate) / 256.0)

    def last_cost(xc, yc):
        ctx_off = 15 if c_idx else (3 * (log2 - 2) + ((log2 - 1) >> 2))
        ctx_shift = (log2 - 2) if c_idx else ((log2 + 1) >> 2)
        rate = 0
        lx, ly = _BLEN[xc], _BLEN[yc]
        for i in range(lx):
            rate += est(off_lastx
                        + min(17, max(0, (i >> ctx_shift) + ctx_off)), 1)
        if lx < 9:
            rate += est(off_lastx
                        + min(17, max(0, (lx >> ctx_shift) + ctx_off)), 0)
        for i in range(ly):
            rate += est(off_lasty
                        + min(17, max(0, (i >> ctx_shift) + ctx_off)), 1)
        if ly < 9:
            rate += est(off_lasty
                        + min(17, max(0, (ly >> ctx_shift) + ctx_off)), 0)
        if lx > 3:
            rate += ((lx - 2) >> 1) << 8
        if ly > 3:
            rate += ((ly - 2) >> 1) << 8
        return lam * (float(rate) / 256.0)

    cf = coeffs.reshape(-1)
    levels = np.zeros(count, np.int32)
    dist0 = [0.0] * count
    rd_coeff = [0.0] * count
    rate_sig = [0.0] * count
    rate_cg_sig = [0.0] * 64
    csbf = [0] * 64
    dist0_total = 0.0
    rd_cost_tu = 0.0
    last_sp = -1
    last_cg = -1
    context_set = 0
    g1_idx = 1
    g1_cnt = 0
    g2_cnt = 0
    rice = 0

    for cgs in range(total_cg - 1, -1, -1):
        cg_x, cg_y = int(cg_scan[cgs, 0]), int(cg_scan[cgs, 1])
        cg_pos = cg_y * cgw + cg_x
        prev_csbf = 0
        if cg_x < cgw - 1:
            prev_csbf += csbf[cg_y * cgw + cg_x + 1]
        if cg_y < cgw - 1:
            prev_csbf += csbf[(cg_y + 1) * cgw + cg_x] << 1
        nz_before_pos0 = 0
        cg_dist0 = 0.0
        cg_rate_sig = 0.0
        cg_rate_sig_pos0 = 0.0
        cg_rd_coeff = 0.0
        for k in range(15, -1, -1):
            sp = cgs * 16 + k
            xc = (cg_x << 2) + int(in_scan[k, 0])
            yc = (cg_y << 2) + int(in_scan[k, 1])
            pos = (yc << log2) + xc
            src = int(cf[pos])
            abs_src = -src if src < 0 else src
            q_lv = (abs_src * q_scale + (1 << (q_shift - 1))) >> q_shift
            if q_lv > 32767:
                q_lv = 32767
            dist0[sp] = float(abs_src) * abs_src * err_scale
            dist0_total += dist0[sp]
            levels[pos] = q_lv
            if q_lv > 0 and last_sp < 0:
                last_sp = sp
                context_set = 0 if (sp < 16 or c_idx != 0) else 2
                last_cg = cgs
            if last_sp >= 0:
                g1_ctx = g1_off + 4 * context_set + g1_idx
                g2_ctx = g2_off + context_set
                sig_idx = off_sig + _sig_ctx(log2, c_idx, scan_idx, xc, yc,
                                             prev_csbf)
                is_last = sp == last_sp
                adj = 0
                if not is_last and q_lv < 3:
                    rate_sig_here = lam * (float(est(sig_idx, 0)) / 256.0)
                    rd_here = dist0[sp] + rate_sig_here
                else:
                    rd_here = float("inf")
                    rate_sig_here = 0.0
                if q_lv != 0 or is_last or q_lv >= 3:
                    sig_cost1 = 0.0 if is_last else lam * (
                        float(est(sig_idx, 1)) / 256.0)
                    min_lv = q_lv - 1 if q_lv > 1 else 1
                    for lv in range(q_lv, min_lv - 1, -1):
                        cl = 32767 if lv > 32767 else lv
                        recon = (cl * inv_scale + inv_offset) >> inv_shift
                        recon = min(32767, max(-32768, recon))
                        err = float(abs_src - recon)
                        c = (err * err * err_scale
                             + level_cost(lv, g1_ctx, g2_ctx, rice, g1_cnt,
                                          g2_cnt)
                             + sig_cost1)
                        if c < rd_here:
                            adj = lv
                            rd_here = c
                            rate_sig_here = sig_cost1
                levels[pos] = adj
                rd_coeff[sp] = rd_here
                rate_sig[sp] = rate_sig_here
                rd_cost_tu += rd_here
                base = (2 + (1 if g2_cnt < 1 else 0)) if g1_cnt < 8 else 1
                if adj >= base and adj > 3 * (1 << rice):
                    rice = min(rice + 1, 4)
                if adj >= 1:
                    g1_cnt += 1
                if adj > 1:
                    g1_idx = 0
                    g2_cnt += 1
                elif 0 < g1_idx < 3 and adj:
                    g1_idx += 1
                if sp % 16 == 0 and sp > 0:
                    rice = 0
                    g1_cnt = 0
                    g2_cnt = 0
                    context_set = 0 if (sp == 16 or c_idx != 0) else 2
                    if g1_idx == 0:
                        context_set += 1
                    g1_idx = 1
            else:
                rd_cost_tu += dist0[sp]
            cg_rate_sig += rate_sig[sp]
            if k == 0:
                cg_rate_sig_pos0 = rate_sig[sp]
            if levels[pos]:
                csbf[cg_pos] = 1
                cg_rd_coeff += rd_coeff[sp] - rate_sig[sp]
                cg_dist0 += dist0[sp]
                if k != 0:
                    nz_before_pos0 += 1
        if last_cg >= 0:
            if cgs:
                cc = 0
                if cg_x < cgw - 1:
                    cc += csbf[cg_y * cgw + cg_x + 1]
                if cg_y < cgw - 1:
                    cc += csbf[(cg_y + 1) * cgw + cg_x]
                csbf_idx = off_csbf + min(cc, 1) + (2 if c_idx else 0)
                if csbf[cg_pos] == 0:
                    cost0 = lam * (float(est(csbf_idx, 0)) / 256.0)
                    rd_cost_tu += cost0 - cg_rate_sig
                    rate_cg_sig[cgs] = cost0
                elif cgs < last_cg:
                    if nz_before_pos0 == 0:
                        rd_cost_tu -= cg_rate_sig_pos0
                        cg_rate_sig -= cg_rate_sig_pos0
                    r0 = lam * (float(est(csbf_idx, 0)) / 256.0)
                    r1 = lam * (float(est(csbf_idx, 1)) / 256.0)
                    rd_zero = rd_cost_tu
                    rd_cost_tu += r1
                    rd_zero += r0
                    rate_cg_sig[cgs] = r1
                    rd_zero += cg_dist0
                    rd_zero -= cg_rd_coeff
                    rd_zero -= cg_rate_sig
                    if rd_zero < rd_cost_tu:
                        csbf[cg_pos] = 0
                        rd_cost_tu = rd_zero
                        rate_cg_sig[cgs] = r0
                        for j in range(15, -1, -1):
                            xj = (cg_x << 2) + int(in_scan[j, 0])
                            yj = (cg_y << 2) + int(in_scan[j, 1])
                            pj = (yj << log2) + xj
                            sj = cgs * 16 + j
                            if levels[pj]:
                                levels[pj] = 0
                                rd_coeff[sj] = dist0[sj]
                                rate_sig[sj] = 0.0
            else:
                csbf[cg_pos] = 1

    if last_sp < 0:
        return levels.reshape(n, n)

    rd_best = dist0_total + lam * (float(est(cbf_ctx_abs, 0)) / 256.0)
    rd_cost_tu += lam * (float(est(cbf_ctx_abs, 1)) / 256.0)
    last_pos_idx = 0
    found = False
    for cgs in range(last_cg, -1, -1):
        if found:
            break
        cg_x, cg_y = int(cg_scan[cgs, 0]), int(cg_scan[cgs, 1])
        rd_cost_tu -= rate_cg_sig[cgs]
        if not csbf[cg_y * cgw + cg_x]:
            continue
        for k in range(15, -1, -1):
            sp = cgs * 16 + k
            if sp > last_sp:
                continue
            xc = (cg_x << 2) + int(in_scan[k, 0])
            yc = (cg_y << 2) + int(in_scan[k, 1])
            pos = (yc << log2) + xc
            if levels[pos]:
                rate_last = (last_cost(yc, xc) if scan_idx == 2
                             else last_cost(xc, yc))
                total = rd_cost_tu + rate_last - rate_sig[sp]
                if total < rd_best:
                    last_pos_idx = sp + 1
                    rd_best = total
                if levels[pos] > 1:
                    found = True
                    break
                rd_cost_tu -= rd_coeff[sp]
                rd_cost_tu += dist0[sp]
            else:
                rd_cost_tu -= rate_sig[sp]

    for sp in range(last_sp + 1):
        cgs, k = sp >> 4, sp & 15
        xc = (int(cg_scan[cgs, 0]) << 2) + int(in_scan[k, 0])
        yc = (int(cg_scan[cgs, 1]) << 2) + int(in_scan[k, 1])
        pos = (yc << log2) + xc
        if sp < last_pos_idx:
            if cf[pos] < 0:
                levels[pos] = -levels[pos]
        else:
            levels[pos] = 0
    return levels.reshape(n, n)
