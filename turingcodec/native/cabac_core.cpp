// Native CABAC decode core: arithmetic engine + residual_coding hot loop.
//
// The serial-host half of the codec (the turing/Read.h:462-676 engine and the
// Read<residual_coding> hot loop at Read.h:1124) implemented in C++ — the
// host-side analogue of the reference's native entropy path.  The Python
// engine (cabac/engine.py) hands its exact state (bit position, ivlCurrRange,
// ivlOffset, context pool) across this boundary per residual block and
// resumes afterwards; bit-exactness vs the Python oracle is asserted by the
// unit suite (tests/test_native.py).
//
// Spec references: decode engine 9.3.4.3; residual_coding 7.3.8.11; context
// derivations 9.3.4.2.5-9.3.4.2.7; coeff_abs_level_remaining 9.3.3.13.
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include "core.h"

uint8_t g_range_lps[64][4];
uint8_t g_next_mps[128];
uint8_t g_next_lps[128];
uint8_t g_sig4x4[16];

// context pool offsets: [sig, csbf, last_x, last_y, gt1, gt2]
int32_t g_off_sig, g_off_csbf, g_off_lastx, g_off_lasty, g_off_gt1, g_off_gt2;

// scan tables: scan[s][idx] for subblock-grid log2 s in 0..3, scan idx 0..2;
// entries are (x, y) pairs in scan order, (1 << 2s) of them.
int8_t g_scan[4][3][2 * 64];

extern "C" {

void tc_init_tables(const uint8_t* range_tab_lps, const uint8_t* next_mps,
                    const uint8_t* next_lps, const uint8_t* sig4x4,
                    const int32_t* ctx_offsets, const int8_t* scans) {
    std::memcpy(g_range_lps, range_tab_lps, 64 * 4);
    std::memcpy(g_next_mps, next_mps, 128);
    std::memcpy(g_next_lps, next_lps, 128);
    std::memcpy(g_sig4x4, sig4x4, 16);
    g_off_sig = ctx_offsets[0];
    g_off_csbf = ctx_offsets[1];
    g_off_lastx = ctx_offsets[2];
    g_off_lasty = ctx_offsets[3];
    g_off_gt1 = ctx_offsets[4];
    g_off_gt2 = ctx_offsets[5];
    const int8_t* p = scans;
    for (int s = 0; s < 4; s++)
        for (int idx = 0; idx < 3; idx++) {
            int n = 1 << (2 * s);
            std::memcpy(g_scan[s][idx], p, 2 * n);
            p += 2 * n;
        }
}

// Decode residual_coding() from the last-position syntax down.
// state: int64[1] pos + int32 range/offset passed separately for simplicity.
// out: int16[(1<<log2)^2] row-major coefficient block (pre-zeroed by caller).
// Returns 0 on success.
int tc_residual_decode(const uint8_t* data, int64_t nbits, int64_t* io_pos,
                       int32_t* io_range, int32_t* io_offset, uint8_t* ctx,
                       int log2_size, int c_idx, int scan_idx, int sdh,
                       int16_t* out) {
    Engine e{data, nbits, *io_pos, (uint32_t)*io_range, (uint32_t)*io_offset};
    int rc = residual_decode_core(e, ctx, log2_size, c_idx, scan_idx, sdh,
                                  out, 1 << log2_size);
    *io_pos = e.pos;
    *io_range = (int32_t)e.range;
    *io_offset = (int32_t)e.offset;
    return rc;
}

}  // extern "C"

// The residual_coding() body shared by the ctypes entry above and the full
// CTU parse (slice_parse.cpp). `out` points at the block's top-left sample
// inside a strided, pre-zeroed int16 plane.
int residual_decode_core(Engine& e, uint8_t* ctx, int log2_size, int c_idx,
                         int scan_idx, int sdh, int16_t* out,
                         int out_stride) {
    const int n = 1 << log2_size;
    (void)n;
    const int nsb = 1 << (log2_size - 2);
    const int n_sub = nsb * nsb;

    // last_sig_coeff prefix/suffix (spec 9.3.4.2.3 contexts)
    int c_max = (log2_size << 1) - 1;
    int ctx_off, ctx_shift;
    if (c_idx == 0) {
        ctx_off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2);
        ctx_shift = (log2_size + 1) >> 2;
    } else {
        ctx_off = 15;
        ctx_shift = log2_size - 2;
    }
    int px = 0, py = 0;
    while (px < c_max &&
           e.decode_decision(ctx, g_off_lastx + (px >> ctx_shift) + ctx_off))
        px++;
    while (py < c_max &&
           e.decode_decision(ctx, g_off_lasty + (py >> ctx_shift) + ctx_off))
        py++;
    int last_x = px, last_y = py;
    if (px > 3) {
        int nb = (px >> 1) - 1;
        last_x = ((2 + (px & 1)) << nb) + e.decode_bypass_bits(nb);
    }
    if (py > 3) {
        int nb = (py >> 1) - 1;
        last_y = ((2 + (py & 1)) << nb) + e.decode_bypass_bits(nb);
    }
    if (scan_idx == 2) {
        int t = last_x; last_x = last_y; last_y = t;
    }

    // g_scan[k] is the scan of a (1<<k)x(1<<k) grid; within-subblock = k==2
    const int8_t* sub_scan = g_scan[log2_size - 2][scan_idx];
    const int8_t* pos_scan = g_scan[2][scan_idx];

    int sub_of_last = -1, pos_of_last = -1;
    int lx_s = last_x >> 2, ly_s = last_y >> 2;
    for (int i = 0; i < n_sub; i++)
        if (sub_scan[2 * i] == lx_s && sub_scan[2 * i + 1] == ly_s) {
            sub_of_last = i;
            break;
        }
    int lx_p = last_x & 3, ly_p = last_y & 3;
    for (int i = 0; i < 16; i++)
        if (pos_scan[2 * i] == lx_p && pos_scan[2 * i + 1] == ly_p) {
            pos_of_last = i;
            break;
        }
    if (sub_of_last < 0 || pos_of_last < 0)
        return 1;

    uint8_t csbf[8][8];
    std::memset(csbf, 0, sizeof(csbf));
    int c1_chain_gt1 = 0;

    for (int i = sub_of_last; i >= 0; i--) {
        int xs = sub_scan[2 * i], ys = sub_scan[2 * i + 1];
        int infer_sb_dc = 0;
        int sb_coded = 1;
        if (i < sub_of_last && i > 0) {
            int inc = ((xs + 1 < nsb && csbf[ys][xs + 1]) ||
                       (ys + 1 < nsb && csbf[ys + 1][xs])) ? 1 : 0;
            sb_coded = e.decode_decision(
                ctx, g_off_csbf + inc + (c_idx ? 2 : 0));
            infer_sb_dc = 1;
        }
        csbf[ys][xs] = (uint8_t)sb_coded;
        if (!sb_coded)
            continue;

        uint8_t sig[16];
        std::memset(sig, 0, 16);
        if (i == sub_of_last)
            sig[pos_of_last] = 1;
        int start_n = (i == sub_of_last) ? pos_of_last - 1 : 15;
        int prev_csbf = 0;
        if (xs + 1 < nsb && csbf[ys][xs + 1]) prev_csbf += 1;
        if (ys + 1 < nsb && csbf[ys + 1][xs]) prev_csbf += 2;
        for (int nn = start_n; nn >= 0; nn--) {
            if (nn > 0 || !infer_sb_dc) {
                int xp = pos_scan[2 * nn], yp = pos_scan[2 * nn + 1];
                int xc = (xs << 2) + xp, yc = (ys << 2) + yp;
                int sc = sig_ctx(log2_size, c_idx, scan_idx, xc, yc, xp, yp,
                                 xs, ys, prev_csbf);
                int b = e.decode_decision(ctx, g_off_sig + sc);
                sig[nn] = (uint8_t)b;
                if (b)
                    infer_sb_dc = 0;
            } else {
                sig[nn] = 1;
            }
        }

        int sig_pos[16], n_sig = 0;
        for (int nn = 15; nn >= 0; nn--)
            if (sig[nn])
                sig_pos[n_sig++] = nn;
        if (!n_sig)
            continue;

        int ctx_set = ((i == 0 || c_idx > 0) ? 0 : 2) + (c1_chain_gt1 ? 1 : 0);
        int c1 = 1;
        c1_chain_gt1 = 0;
        uint8_t gt1[16];
        std::memset(gt1, 0, 16);
        int first_gt1_pos = -1;
        int n_g1 = n_sig < 8 ? n_sig : 8;
        for (int k = 0; k < n_g1; k++) {
            int nn = sig_pos[k];
            int b = e.decode_decision(
                ctx, g_off_gt1 + ctx_set * 4 + c1 + (c_idx ? 16 : 0));
            gt1[nn] = (uint8_t)b;
            if (b) {
                c1 = 0;
                c1_chain_gt1 = 1;
                if (first_gt1_pos < 0)
                    first_gt1_pos = nn;
            } else if (c1 > 0 && c1 < 3) {
                c1++;
            }
        }
        int gt2_val = 0;
        if (first_gt1_pos >= 0)
            gt2_val = e.decode_decision(
                ctx, g_off_gt2 + ctx_set + (c_idx ? 4 : 0));

        int first_sig_scan = sig_pos[n_sig - 1];
        int last_sig_scan = sig_pos[0];
        int sign_hidden = sdh && (last_sig_scan - first_sig_scan > 3);
        uint8_t signs[16];
        std::memset(signs, 0, 16);
        for (int k = 0; k < n_sig; k++) {
            int nn = sig_pos[k];
            if (sign_hidden && nn == first_sig_scan)
                continue;
            signs[nn] = (uint8_t)e.decode_bypass();
        }

        int rice = 0;
        int levels[16];
        int sum_abs = 0;
        for (int k = 0; k < n_sig; k++) {
            int nn = sig_pos[k];
            int base = 1;
            bool need_rem;
            if (k < 8) {
                base += gt1[nn];
                if (nn == first_gt1_pos)
                    base += gt2_val;
                need_rem = (nn == first_gt1_pos && gt2_val) ||
                           (gt1[nn] && nn != first_gt1_pos);
            } else {
                need_rem = true;
            }
            int level = base;
            if (need_rem) {
                level = base + e.decode_remaining(rice);
                if (level > (3 << rice) && rice < 4)
                    rice++;
            }
            levels[k] = level;
            sum_abs += level;
        }

        for (int k = 0; k < n_sig; k++) {
            int nn = sig_pos[k];
            int xc = (xs << 2) + pos_scan[2 * nn];
            int yc = (ys << 2) + pos_scan[2 * nn + 1];
            int neg = (sign_hidden && nn == first_sig_scan) ? (sum_abs & 1)
                                                            : signs[nn];
            out[yc * out_stride + xc] = (int16_t)(neg ? -levels[k]
                                                      : levels[k]);
        }
    }
    return 0;
}

// ---------------------------------------------------------------- intra TU
// Serial intra reconstruction chain for one TB: reference-sample build +
// substitution (spec 8.4.4.2.2), [1 2 1]/strong smoothing (8.4.4.2.3),
// prediction incl. DC/H/V edge filters (8.4.4.2.4-6), dequant (8.6.3) and
// two-stage inverse transform (8.6.4) — the C++ twin of
// decode/reconstruct.py build/filter/intra_predict/dequant/inverse_transform
// and decode/picture_recon._recon_intra_cu's per-TU body. The intra chain
// is z-order serial (each TU predicts from previous reconstructions), so it
// stays on the host like the reference's native Decode path.

// angle tables shared with the encoder's sweep kernel (core.h extern)
int8_t g_angle[35];
int16_t g_inv_angle[35];

namespace {

const int32_t* g_dct[6];  // log2 2..5 -> DCT matrix, [5]=DST4
int32_t g_mat_store[4 * 4 + 8 * 8 + 16 * 16 + 32 * 32 + 16];
int32_t g_level_scale[6];

inline int iclip(int lo, int hi, long long v) {
    return v < lo ? lo : (v > hi ? hi : (int)v);
}

void inverse_transform_add(const int16_t* coeff, int cw, long long ls,
                           int bd_shift, int n, const int32_t* m,
                           int bit_depth, int32_t* pred /* n*n, in/out */) {
    // dequant into d[y][x]
    static thread_local int32_t d[32 * 32];
    static thread_local int32_t g[32 * 32];
    long long rnd = 1LL << (bd_shift - 1);
    for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
            d[y * n + x] = iclip(-32768, 32767,
                                 ((long long)coeff[y * cw + x] * ls + rnd)
                                     >> bd_shift);
    int sh2 = 20 - bit_depth;
    int32_t rnd2 = 1 << (sh2 - 1);
    if (n == 4) {  // DST4 (no even/odd symmetry) and 4x4 DCT: naive
        // stage 1: g = clip((M^T @ d + 64) >> 7); int32 exact
        // (|acc| <= 32 * 90 * 32767 < 2^27)
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) {
                int32_t acc = 0;
                for (int k = 0; k < n; k++)
                    acc += m[k * n + y] * d[k * n + x];
                g[y * n + x] = iclip(-32768, 32767, (acc + 64) >> 7);
            }
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) {
                int32_t acc = 0;
                for (int k = 0; k < n; k++)
                    acc += g[y * n + k] * m[k * n + x];
                pred[y * n + x] +=
                    iclip(-32768, 32767, (acc + rnd2) >> sh2);
            }
        return;
    }
    // DCT 8/16/32: cosine symmetry m[k][n-1-y] == +/- m[k][y] (+ even k,
    // - odd k) lets each output pair (y, n-1-y) share one half-length sum:
    // out[y] = E + O, out[n-1-y] = E - O — exact integer regrouping, so
    // results stay bit-identical to the plain matrix product.
    const int h = n >> 1;
    // stage 1: g[y][x] = clip((sum_k m[k][y] d[k][x] + 64) >> 7)
    // x stays the contiguous inner (vector) dimension
    {
        static thread_local int32_t accE[32], accO[32];
        for (int y = 0; y < h; y++) {
            for (int x = 0; x < n; x++) {
                accE[x] = 0;
                accO[x] = 0;
            }
            for (int k = 0; k < n; k += 2) {
                const int32_t ce = m[k * n + y];
                const int32_t co = m[(k + 1) * n + y];
                const int32_t* de = d + k * n;
                const int32_t* dd = d + (k + 1) * n;
                for (int x = 0; x < n; x++) {
                    accE[x] += ce * de[x];
                    accO[x] += co * dd[x];
                }
            }
            int32_t* gy = g + y * n;
            int32_t* gm = g + (n - 1 - y) * n;
            for (int x = 0; x < n; x++) {
                gy[x] = iclip(-32768, 32767, (accE[x] + accO[x] + 64) >> 7);
                gm[x] = iclip(-32768, 32767, (accE[x] - accO[x] + 64) >> 7);
            }
        }
    }
    // stage 2: r[y][x] = clip((sum_k g[y][k] m[k][x] + rnd2) >> sh2);
    // fold over x: E[x]/O[x] for x < h, outputs at x and n-1-x
    {
        static thread_local int32_t accE[16], accO[16];
        for (int y = 0; y < n; y++) {
            const int32_t* gy = g + y * n;
            for (int x = 0; x < h; x++) {
                accE[x] = 0;
                accO[x] = 0;
            }
            for (int k = 0; k < n; k += 2) {
                const int32_t ge = gy[k];
                const int32_t go = gy[k + 1];
                const int32_t* me = m + k * n;
                const int32_t* mo = m + (k + 1) * n;
                for (int x = 0; x < h; x++) {
                    accE[x] += ge * me[x];
                    accO[x] += go * mo[x];
                }
            }
            int32_t* py = pred + y * n;
            for (int x = 0; x < h; x++) {
                py[x] += iclip(-32768, 32767,
                               (accE[x] + accO[x] + rnd2) >> sh2);
                py[n - 1 - x] += iclip(-32768, 32767,
                                       (accE[x] - accO[x] + rnd2) >> sh2);
            }
        }
    }
}

}  // namespace

extern "C" {

void tc_init_intra(const int32_t* m4, const int32_t* m8, const int32_t* m16,
                   const int32_t* m32, const int32_t* dst4,
                   const int32_t* level_scale, const int8_t* angles,
                   const int16_t* inv_angles) {
    // g_dct[2..5] = DCT 4/8/16/32; g_dct[0] = DST4
    int32_t* p = g_mat_store;
    const int32_t* srcs[5] = {m4, m8, m16, m32, dst4};
    const int slots[5] = {2, 3, 4, 5, 0};
    const int sizes[5] = {16, 64, 256, 1024, 16};
    for (int i = 0; i < 5; i++) {
        std::memcpy(p, srcs[i], sizes[i] * 4);
        g_dct[slots[i]] = p;
        p += sizes[i];
    }
    g_dct[1] = nullptr;
    std::memcpy(g_level_scale, level_scale, 6 * 4);
    std::memcpy(g_angle, angles, 35);
    std::memcpy(g_inv_angle, inv_angles, 35 * 2);
}

}  // extern "C"

// Build (+substitute) the 2n top / 2n left reference samples and corner for
// an intra TB at (x0, y0) in plane coordinates (spec 8.4.4.2.2). sub = 1
// for luma, 2 for 4:2:0 chroma (availability in luma min-block units).
void build_intra_refs(const int16_t* plane, int pw, int ph,
                      const int32_t* zscan, int zw, int x0, int y0, int n,
                      int sub, int bit_depth, int32_t* rt, int32_t* rl,
                      int32_t* corner) {
    const int m = 4 * n + 1;
    int32_t vals[129];
    uint8_t ok[129];
    int zcur = zscan[(((long)y0 * sub) >> 2) * zw + (((long)x0 * sub) >> 2)];
    int any = 0, first = -1;
    for (int i = 0; i < m; i++) {
        int px, py;
        if (i < 2 * n) {
            px = x0 - 1;
            py = y0 + (2 * n - 1 - i);
        } else if (i == 2 * n) {
            px = x0 - 1;
            py = y0 - 1;
        } else {
            px = x0 + (i - (2 * n + 1));
            py = y0 - 1;
        }
        int inb = px >= 0 && py >= 0 && px < pw && py < ph;
        int pxc = px < 0 ? 0 : (px >= pw ? pw - 1 : px);
        int pyc = py < 0 ? 0 : (py >= ph ? ph - 1 : py);
        int o = inb && (zscan[(((long)pyc * sub) >> 2) * zw
                              + (((long)pxc * sub) >> 2)] <= zcur);
        vals[i] = plane[(long)pyc * pw + pxc];
        ok[i] = (uint8_t)o;
        if (o && first < 0)
            first = i;
        any |= o;
    }
    if (!any) {
        int mid = 1 << (bit_depth - 1);
        for (int i = 0; i < m; i++)
            vals[i] = mid;
    } else {
        if (!ok[0])
            vals[0] = vals[first];
        for (int i = 1; i < m; i++)
            if (!ok[i])
                vals[i] = vals[i - 1];
    }
    for (int i = 0; i < 2 * n; i++)
        rl[i] = vals[2 * n - 1 - i];
    *corner = vals[2 * n];
    for (int i = 0; i < 2 * n; i++)
        rt[i] = vals[2 * n + 1 + i];
}

// In-place reference filtering with per-mode gating (spec 8.4.4.2.3).
void filter_intra_refs(int32_t* rt, int32_t* rl, int32_t* corner, int n,
                       int mode, int strong_smoothing, int bit_depth) {
    if (n <= 4 || mode == 1)
        return;
    int mind = mode == 0 ? 99
             : (abs(mode - 26) < abs(mode - 10) ? abs(mode - 26)
                                                : abs(mode - 10));
    int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
    if (!(mode == 0 || mind > thres))
        return;
    int32_t c = *corner;
    bool strong = false;
    if (strong_smoothing && n == 32) {
        int t1 = abs(c + rt[2 * n - 1] - 2 * rt[n - 1]);
        int t2 = abs(c + rl[2 * n - 1] - 2 * rl[n - 1]);
        strong = t1 < (1 << (bit_depth - 5)) && t2 < (1 << (bit_depth - 5));
    }
    if (strong) {
        int32_t t63 = rt[63], l63 = rl[63];
        for (int i = 0; i < 63; i++) {
            rt[i] = ((63 - i) * c + (i + 1) * t63 + 32) >> 6;
            rl[i] = ((63 - i) * c + (i + 1) * l63 + 32) >> 6;
        }
    } else {
        int32_t ft[64], fl[64];
        ft[0] = (c + 2 * rt[0] + rt[1] + 2) >> 2;
        fl[0] = (c + 2 * rl[0] + rl[1] + 2) >> 2;
        for (int i = 1; i < 2 * n - 1; i++) {
            ft[i] = (rt[i - 1] + 2 * rt[i] + rt[i + 1] + 2) >> 2;
            fl[i] = (rl[i - 1] + 2 * rl[i] + rl[i + 1] + 2) >> 2;
        }
        ft[2 * n - 1] = rt[2 * n - 1];
        fl[2 * n - 1] = rl[2 * n - 1];
        int32_t fc = (rl[0] + 2 * c + rt[0] + 2) >> 2;
        std::memcpy(rt, ft, sizeof(int32_t) * 2 * n);
        std::memcpy(rl, fl, sizeof(int32_t) * 2 * n);
        *corner = fc;
    }
}

// Intra prediction from prepared refs (spec 8.4.4.2.4-6).
void intra_predict_core(int mode, const int32_t* rt, const int32_t* rl,
                        int32_t corner, int n, int c_idx, int bit_depth,
                        int disable_edge, int32_t* pred) {
    int max_val = (1 << bit_depth) - 1;
    int log2n = 0;
    while ((1 << log2n) < n)
        log2n++;
    if (mode == 0) {  // planar
        int tr = rt[n], bl = rl[n];
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++)
                pred[y * n + x] =
                    (int)((((long long)(n - 1 - x) * rl[y]
                            + (long long)(x + 1) * tr
                            + (long long)(n - 1 - y) * rt[x]
                            + (long long)(y + 1) * bl + n) >> (log2n + 1)));
    } else if (mode == 1) {  // DC
        long long s = 0;
        for (int i = 0; i < n; i++)
            s += rt[i] + rl[i];
        int dc = (int)((s + n) >> (log2n + 1));
        for (int i = 0; i < n * n; i++)
            pred[i] = dc;
        if (c_idx == 0 && n < 32 && !disable_edge) {
            for (int x = 0; x < n; x++)
                pred[x] = (rt[x] + 3 * dc + 2) >> 2;
            for (int y = 0; y < n; y++)
                pred[y * n] = (rl[y] + 3 * dc + 2) >> 2;
            pred[0] = (rl[0] + 2 * dc + rt[0] + 2) >> 2;
        }
    } else {  // angular
        int angle = g_angle[mode];
        int32_t main_arr[130];  // index offset n: ref[-n .. 2n+1]
        const int32_t* ref_main = (mode >= 18) ? rt : rl;
        const int32_t* ref_other = (mode >= 18) ? rl : rt;
        main_arr[n] = corner;
        for (int i = 0; i < 2 * n; i++)
            main_arr[n + 1 + i] = ref_main[i];
        main_arr[3 * n + 1] = ref_main[2 * n - 1];
        if (angle < 0) {
            int inv = g_inv_angle[mode];
            int lo = (n * angle) >> 5;
            for (int x = -1; x > lo - 1; x--) {
                int idx = ((x * inv + 128) >> 8) - 1;
                main_arr[n + x] = idx < 0 ? corner
                    : ref_other[idx < 2 * n - 1 ? idx : 2 * n - 1];
            }
        }
        for (int dpos = 1; dpos <= n; dpos++) {
            int i_idx = (dpos * angle) >> 5;
            int i_fact = (dpos * angle) & 31;
            for (int j = 0; j < n; j++) {
                int v = ((32 - i_fact) * main_arr[n + 1 + i_idx + j]
                         + i_fact * main_arr[n + 2 + i_idx + j] + 16) >> 5;
                if (mode >= 18)
                    pred[(dpos - 1) * n + j] = v;     // y = dpos-1, x = j
                else
                    pred[j * n + (dpos - 1)] = v;     // x = dpos-1, y = j
            }
        }
        if (mode == 26 && c_idx == 0 && n < 32 && !disable_edge) {
            for (int y = 0; y < n; y++)
                pred[y * n] = iclip(0, max_val,
                                    rt[0] + ((rl[y] - corner) >> 1));
        } else if (mode == 10 && c_idx == 0 && n < 32 && !disable_edge) {
            for (int x = 0; x < n; x++)
                pred[x] = iclip(0, max_val,
                                rl[0] + ((rt[x] - corner) >> 1));
        }
    }
}

// Dequant + IDCT added into pred (shared with the encoder core).
void dequant_idct_add(const int16_t* coeff, int cstride, int n, int log2,
                      int qp, int bit_depth, int use_dst, int32_t* pred) {
    int bd_shift = bit_depth + log2 - 5;
    long long ls = ((long long)g_level_scale[qp % 6] << (qp / 6)) * 16;
    inverse_transform_add(coeff, cstride, ls, bd_shift, n,
                          use_dst ? g_dct[0] : g_dct[log2], bit_depth, pred);
}

const int32_t* dct_matrix_for(int log2, int use_dst) {
    return use_dst ? g_dct[0] : g_dct[log2];
}

extern "C" {

// Reconstruct one intra TB in place. Returns 0 on success.
int tc_intra_tu(int16_t* plane, int pw, int ph, const int32_t* zscan, int zw,
                int x0, int y0, int n, int c_idx, int sub, int bit_depth,
                int mode, int strong_smoothing, const int16_t* coeff_plane,
                int cbf, int qp, int use_dst) {
    int32_t rl[64], rt[64], corner;
    build_intra_refs(plane, pw, ph, zscan, zw, x0, y0, n, sub, bit_depth,
                     rt, rl, &corner);
    if (c_idx == 0)
        filter_intra_refs(rt, rl, &corner, n, mode, strong_smoothing,
                          bit_depth);
    static thread_local int32_t pred[32 * 32];
    int max_val = (1 << bit_depth) - 1;
    intra_predict_core(mode, rt, rl, corner, n, c_idx, bit_depth, 0, pred);

    if (cbf) {
        int log2n = 0;
        while ((1 << log2n) < n)
            log2n++;
        int log2 = log2n;
        int bd_shift = bit_depth + log2 - 5;
        long long ls = ((long long)g_level_scale[qp % 6] << (qp / 6)) * 16;
        const int32_t* mtx = use_dst ? g_dct[0] : g_dct[log2];
        inverse_transform_add(coeff_plane + (long)y0 * pw + x0, pw, ls,
                              bd_shift, n, mtx, bit_depth, pred);
    }
    for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
            plane[(long)(y0 + y) * pw + (x0 + x)] =
                (int16_t)iclip(0, max_val, pred[y * n + x]);
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------- encoder
// Exact CABAC rate estimation for residual_coding (the EstimateRate.h:33-96
// analogue): accumulates fractional bits (1/256 units) while applying the
// same context transitions as the writer — the C++ twin of
// encode/ctu_write.residual_core driven by cabac/rate.RateEstimator.

int32_t g_rate_bits[128][2];

namespace {
struct RateEst {
    uint8_t* ctx;
    int64_t frac = 0;
    inline void decision(int idx, int bin) {
        uint32_t s = ctx[idx];
        frac += g_rate_bits[s][bin];
        ctx[idx] = (bin == (int)(s & 1)) ? g_next_mps[s] : g_next_lps[s];
    }
    inline void bypass(int n) { frac += (int64_t)n << 8; }
};
}  // namespace

extern "C" {

void tc_init_rate(const int32_t* bits) {
    std::memcpy(g_rate_bits, bits, sizeof(g_rate_bits));
}

// Fractional bits (1/256) of residual_coding for `blk`, mutating `ctx`
// exactly like the writer would. Returns -1 on an all-zero block.
int64_t tc_residual_bits(uint8_t* ctx, int log2_size, int c_idx,
                         int scan_idx, int sdh, const int16_t* blk) {
    RateEst e{ctx};
    const int n = 1 << log2_size;
    const int nsb = 1 << (log2_size - 2);
    const int n_sub = nsb * nsb;
    const int8_t* sub_scan = g_scan[log2_size - 2][scan_idx];
    const int8_t* pos_scan = g_scan[2][scan_idx];

    // coefficient fetch in subblock scan order
    auto coef = [&](int xs, int ys, int nn) -> int {
        int xc = (xs << 2) + pos_scan[2 * nn];
        int yc = (ys << 2) + pos_scan[2 * nn + 1];
        return blk[yc * n + xc];
    };

    // last significant coefficient
    int last_i = -1, last_n = -1;
    for (int i = n_sub - 1; i >= 0 && last_i < 0; i--) {
        int xs = sub_scan[2 * i], ys = sub_scan[2 * i + 1];
        for (int nn = 15; nn >= 0; nn--)
            if (coef(xs, ys, nn)) {
                last_i = i;
                last_n = nn;
                break;
            }
    }
    if (last_i < 0)
        return -1;
    int lxs = sub_scan[2 * last_i], lys = sub_scan[2 * last_i + 1];
    int last_x = (lxs << 2) + pos_scan[2 * last_n];
    int last_y = (lys << 2) + pos_scan[2 * last_n + 1];
    int wx = last_x, wy = last_y;
    if (scan_idx == 2) {
        wx = last_y;
        wy = last_x;
    }

    int c_max = (log2_size << 1) - 1;
    int ctx_off, ctx_shift;
    if (c_idx == 0) {
        ctx_off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2);
        ctx_shift = (log2_size + 1) >> 2;
    } else {
        ctx_off = 15;
        ctx_shift = log2_size - 2;
    }
    auto last_prefix = [&](int base_off, int v) -> int {
        int prefix = v;
        if (v > 3) {
            int p = 0;
            while (p < c_max) {
                int lo, hi;
                if (p <= 3) {
                    lo = hi = p;
                } else {
                    int k = (p >> 1) - 1;
                    lo = (2 + (p & 1)) << k;
                    hi = lo + (1 << k) - 1;
                }
                if (lo <= v && v <= hi)
                    break;
                p++;
            }
            prefix = p;
        }
        for (int k = 0; k < prefix; k++)
            e.decision(base_off + (k >> ctx_shift) + ctx_off, 1);
        if (prefix < c_max)
            e.decision(base_off + (prefix >> ctx_shift) + ctx_off, 0);
        return prefix;
    };
    int px = last_prefix(g_off_lastx, wx);
    int py = last_prefix(g_off_lasty, wy);
    if (px > 3)
        e.bypass((px >> 1) - 1);
    if (py > 3)
        e.bypass((py >> 1) - 1);

    uint8_t csbf[8][8];
    for (int ys = 0; ys < nsb; ys++)
        for (int xs = 0; xs < nsb; xs++) {
            uint8_t any = 0;
            for (int nn = 0; nn < 16 && !any; nn++)
                any = coef(xs, ys, nn) != 0;
            csbf[ys][xs] = any;
        }

    int c1_chain_gt1 = 0;
    for (int i = last_i; i >= 0; i--) {
        int xs = sub_scan[2 * i], ys = sub_scan[2 * i + 1];
        int sb_coded = csbf[ys][xs];
        int infer_sb_dc = 0;
        if (i < last_i && i > 0) {
            int inc = ((xs + 1 < nsb && csbf[ys][xs + 1]) ||
                       (ys + 1 < nsb && csbf[ys + 1][xs])) ? 1 : 0;
            e.decision(g_off_csbf + inc + (c_idx ? 2 : 0), sb_coded);
            infer_sb_dc = 1;
        } else {
            sb_coded = 1;
            csbf[ys][xs] = 1;
        }
        if (!sb_coded)
            continue;

        int levels[16];
        uint8_t sig[16];
        for (int nn = 0; nn < 16; nn++) {
            levels[nn] = coef(xs, ys, nn);
            sig[nn] = levels[nn] != 0;
        }
        int start_n = (i == last_i) ? last_n - 1 : 15;
        int prev_csbf = 0;
        if (xs + 1 < nsb && csbf[ys][xs + 1]) prev_csbf += 1;
        if (ys + 1 < nsb && csbf[ys + 1][xs]) prev_csbf += 2;
        for (int nn = start_n; nn >= 0; nn--) {
            if (nn > 0 || !infer_sb_dc) {
                int xp = pos_scan[2 * nn], yp = pos_scan[2 * nn + 1];
                int sc = sig_ctx(log2_size, c_idx, scan_idx,
                                 (xs << 2) + xp, (ys << 2) + yp, xp, yp,
                                 xs, ys, prev_csbf);
                e.decision(g_off_sig + sc, sig[nn]);
                if (sig[nn])
                    infer_sb_dc = 0;
            }
        }

        int sig_pos[16], n_sig = 0;
        for (int nn = 15; nn >= 0; nn--)
            if (sig[nn])
                sig_pos[n_sig++] = nn;
        if (!n_sig)
            continue;

        int ctx_set = ((i == 0 || c_idx > 0) ? 0 : 2) + (c1_chain_gt1 ? 1 : 0);
        int c1 = 1;
        c1_chain_gt1 = 0;
        uint8_t gt1[16];
        std::memset(gt1, 0, 16);
        int first_gt1_pos = -1;
        int n_g1 = n_sig < 8 ? n_sig : 8;
        for (int k = 0; k < n_g1; k++) {
            int nn = sig_pos[k];
            int g = (levels[nn] < 0 ? -levels[nn] : levels[nn]) > 1;
            e.decision(g_off_gt1 + ctx_set * 4 + c1 + (c_idx ? 16 : 0), g);
            gt1[nn] = (uint8_t)g;
            if (g) {
                c1 = 0;
                c1_chain_gt1 = 1;
                if (first_gt1_pos < 0)
                    first_gt1_pos = nn;
            } else if (c1 > 0 && c1 < 3) {
                c1++;
            }
        }
        int gt2_val = 0;
        if (first_gt1_pos >= 0) {
            int a = levels[first_gt1_pos] < 0 ? -levels[first_gt1_pos]
                                              : levels[first_gt1_pos];
            gt2_val = a > 2;
            e.decision(g_off_gt2 + ctx_set + (c_idx ? 4 : 0), gt2_val);
        }

        int first_sig_scan = sig_pos[n_sig - 1];
        int last_sig_scan = sig_pos[0];
        int sign_hidden = sdh && (last_sig_scan - first_sig_scan > 3);
        e.bypass(n_sig - (sign_hidden ? 1 : 0));  // sign bins

        int rice = 0;
        for (int k = 0; k < n_sig; k++) {
            int nn = sig_pos[k];
            int a = levels[nn] < 0 ? -levels[nn] : levels[nn];
            int base = 1;
            bool need_rem;
            if (k < 8) {
                base += gt1[nn];
                if (nn == first_gt1_pos)
                    base += gt2_val;
                need_rem = (nn == first_gt1_pos && gt2_val) ||
                           (gt1[nn] && nn != first_gt1_pos);
            } else {
                need_rem = true;
            }
            if (need_rem) {
                int value = a - base;
                // coeff_abs_level_remaining binarization cost
                if ((value >> rice) <= 3) {
                    e.bypass((value >> rice) + 1 + rice);
                } else {
                    int prefix = 4;
                    while (true) {
                        int b = ((1 << (prefix - 3)) + 2) << rice;
                        int nb = prefix - 3 + rice;
                        if (value < b + (1 << nb))
                            break;
                        prefix++;
                    }
                    e.bypass(prefix + 1 + (prefix - 3 + rice));
                }
                if (a > (3 << rice) && rice < 4)
                    rice++;
            }
        }
    }
    return e.frac;
}

}  // extern "C"
