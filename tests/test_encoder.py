"""Encoder round-trip oracle (SURVEY.md §4.2 analogue): the written stream
must decode — in our own decoder — to exactly the encoder's reconstruction,
and the writer must be the exact inverse of the parser."""
import numpy as np
import pytest

from turingcodec.decode.decoder import Decoder
from turingcodec.encode.encoder import Encoder, EncoderConfig


def _synthetic_frame(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (128 + 64 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
         + rng.normal(0, 6, (h, w))).clip(0, 255).astype(np.int16)
    cb = (128 + 32 * np.sin(xx[::2, ::2] / 23.0)).clip(0, 255).astype(np.int16)
    cr = (128 + 32 * np.cos(yy[::2, ::2] / 19.0)).clip(0, 255).astype(np.int16)
    return [y, cb, cr]


@pytest.mark.parametrize("qp", [22, 32, 40])
def test_intra_roundtrip(qp):
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, qp=qp, rd_candidates=2)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    for i in range(2):
        nal, recon = enc.encode_frame(_synthetic_frame(w, h, i))
        stream += nal
        recons.append(recon)
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 2
    for f, recon in zip(frames, recons):
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)


def test_lowdelay_p_roundtrip():
    """IDR + 2 P frames: decode must equal encoder recon bit-exactly."""
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=2,
                        search_range=16)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    base = _synthetic_frame(w, h, 0)
    for i in range(3):
        # translate content to exercise motion estimation
        f = [np.roll(p, i * 2, axis=1) for p in base]
        nal, recon = enc.encode_frame(f)
        stream += nal
        recons.append(recon)
    frames = list(Decoder().decode_stream(stream))
    assert len(frames) == 3
    for f, recon in zip(frames, recons):
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)


def test_hierarchical_b_roundtrip():
    """IDR + GOP4 hierarchical B: decode equals encoder recon."""
    w, h = 64, 64
    cfg = EncoderConfig(width=w, height=h, qp=32, rd_candidates=2,
                        search_range=8, gop_m=4)
    enc = Encoder(cfg)
    stream = enc.headers()
    base = _synthetic_frame(w, h, 1)
    recons = {}
    for i in range(5):
        f = [np.roll(p, i, axis=0) for p in base]
        for (idx, nal, recon) in enc.push_frame(f):
            stream += nal
            recons[idx] = recon
    for (idx, nal, recon) in enc.flush():
        stream += nal
        recons[idx] = recon
    frames = list(Decoder().decode_stream(stream))
    assert len(frames) == 5
    assert [f.poc for f in frames] == [0, 1, 2, 3, 4]
    for f in frames:
        for a, b in zip(f.planes, recons[f.poc]):
            np.testing.assert_array_equal(a, b)


def test_intra_quality():
    """PSNR sanity: QP22 encode of smooth content is > 38 dB."""
    w, h = 128, 64
    frame = _synthetic_frame(w, h, 0)
    cfg = EncoderConfig(width=w, height=h, qp=22, rd_candidates=2)
    enc = Encoder(cfg)
    _, recon = enc.encode_frame(frame)
    mse = ((recon[0].astype(float) - frame[0].astype(float)) ** 2).mean()
    psnr = 10 * np.log10(255 ** 2 / mse)
    assert psnr > 38.0, psnr


def test_writer_parser_inverse():
    """parse(write(plan)) reproduces the plan's decision tensors."""
    from turingcodec.bitstream.reader import BitReader, iter_nal_units
    from turingcodec.hevc import types as T
    from turingcodec.hevc.header_syntax import (
        parse_pps, parse_slice_segment_header, parse_sps, parse_vps)
    from turingcodec.hevc.params import ParamSets
    from turingcodec.hevc.geometry import PictureGeometry
    from turingcodec.decode.plan import PicturePlan
    from turingcodec.decode.slice_data import parse_slice_segment_data

    w, h = 64, 64
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=2)
    enc = Encoder(cfg)
    stream = enc.headers()
    frame = _synthetic_frame(w, h, 3)
    nal, _ = enc.encode_frame(frame)
    stream += nal

    ps = ParamSets()
    plan2 = None
    for nal_u in iter_nal_units(stream):
        br = BitReader(nal_u.rbsp)
        if nal_u.nal_unit_type == T.NalUnitType.VPS_NUT:
            parse_vps(br)
        elif nal_u.nal_unit_type == T.NalUnitType.SPS_NUT:
            s = parse_sps(br)
            ps.sps[0] = s
        elif nal_u.nal_unit_type == T.NalUnitType.PPS_NUT:
            p = parse_pps(br)
            ps.pps[0] = p
        elif T.is_vcl(nal_u.nal_unit_type):
            sh = parse_slice_segment_header(
                br, nal_u.nal_unit_type, 0, ps)
            sps, pps = ps.activate(0)
            geom = PictureGeometry(sps, pps)
            plan2 = PicturePlan(sps, pps)
            plan2.slice_headers.append(sh)
            parse_slice_segment_data(plan2, geom, sh, nal_u.rbsp,
                                     (br.pos + 7) & ~7, 0)
    # compare decision tensors against the encoder's plan
    plan1 = enc._last_plan
    for name in ("ct_depth", "cu_pred_mode", "part_mode", "intra_mode_y",
                 "intra_mode_c", "tu_log2", "cbf_y", "cbf_cb", "cbf_cr",
                 "coeff_y", "coeff_cb", "coeff_cr"):
        np.testing.assert_array_equal(
            getattr(plan1, name), getattr(plan2, name), err_msg=name)


def test_weighted_prediction_roundtrip():
    """Explicit WP (luma+chroma weights) on a fading sequence: decode must
    equal encoder recon bit-exactly (spec 8.5.3.3.4.3 / 7.4.7.3)."""
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=2,
                        search_range=8, wp_luma=(59, 6, 2),
                        wp_chroma=(-4, 3))
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    base = _synthetic_frame(w, h, 3)
    for i in range(3):
        g = 1.0 - 0.07 * i
        f = [np.clip(p * g, 0, 255).astype(np.int16) for p in base]
        nal, recon = enc.encode_frame(f)
        stream += nal
        recons.append(recon)
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 3 and not dec.violations
    for f, recon in zip(frames, recons):
        assert f.hash_ok
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)


def test_prefix_sei_and_vui():
    """APS/user-data/mastering-display/ATC/pic-timing SEIs + VUI survive the
    encode->decode round trip with structured parse (Annex D / E)."""
    w, h = 64, 64
    md = ([(35400, 14600), (8500, 39850), (6550, 2300)], (15635, 16450),
          10000000, 50)
    cfg = EncoderConfig(width=w, height=h, qp=32, all_intra=True,
                        rd_candidates=1, sei_pic_timing=True,
                        mastering_display=md, alt_transfer=18,
                        frame_rate=25.0)
    enc = Encoder(cfg)
    stream = enc.headers()
    for i in range(2):
        nal, _ = enc.encode_frame(_synthetic_frame(w, h, i))
        stream += nal
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 2 and not dec.violations
    types = [t for t, _ in dec.sei_log]
    from turingcodec.hevc import sei as S
    assert types.count(S.SEI_PIC_TIMING) == 2
    assert S.SEI_ACTIVE_PARAMETER_SETS in types
    assert S.SEI_USER_DATA_UNREGISTERED in types
    got_md = dict(dec.sei_log)[S.SEI_MASTERING_DISPLAY]
    assert got_md["primaries"] == md[0] and got_md["white_point"] == md[1]
    assert got_md["max_luminance"] == md[2] and got_md["min_luminance"] == md[3]
    assert dict(dec.sei_log)[S.SEI_ALTERNATIVE_TRANSFER][
        "preferred_transfer_characteristics"] == 18
    # VUI round trip through the parsed SPS
    sps = list(dec.ps.sps.values())[0]
    assert sps.vui is not None and sps.vui.timing_info == (1000, 25000)
    assert sps.vui.frame_field_info_present_flag == 1


def test_multislice_roundtrip():
    """3 independent slices per picture (CTU-row aligned): decode must equal
    encoder recon; cross-slice prediction is broken at slice boundaries."""
    w, h = 128, 192  # 3 CTU rows of 64
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=1,
                        search_range=8, wpp=False, slices=3)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    base = _synthetic_frame(w, h, 5)
    for i in range(2):
        f = [np.roll(p, i * 2, axis=1) for p in base]
        nal, recon = enc.encode_frame(f)
        stream += nal
        recons.append(recon)
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 2 and not dec.violations
    for f, recon in zip(frames, recons):
        assert f.hash_ok
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)


def test_dependent_slices_roundtrip():
    """Dependent slice segments: CABAC contexts continue across segments,
    in-picture prediction crosses segment boundaries (spec 7.4.7.1/9.3.1)."""
    w, h = 128, 192
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=1,
                        search_range=8, wpp=False, slices=3,
                        dependent_slices=True)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    base = _synthetic_frame(w, h, 6)
    for i in range(2):
        f = [np.roll(p, i * 2, axis=1) for p in base]
        nal, recon = enc.encode_frame(f)
        stream += nal
        recons.append(recon)
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 2 and not dec.violations
    for f, recon in zip(frames, recons):
        assert f.hash_ok
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)


def test_smp_inter_partitions_roundtrip():
    """2NxN / Nx2N inter partitions with the forced transform split: decode
    must equal encoder recon, and SMP must actually be selected."""
    rng = np.random.default_rng(13)
    w, h = 192, 128
    base = rng.integers(0, 256, (h, w)).astype(np.uint8)
    cb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    cr = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    frames = []
    for k in range(3):
        y = base.copy()
        y[:, :w // 2] = np.roll(base[:, :w // 2], 3 * k, axis=0)
        y[:, w // 2:] = np.roll(base[:, w // 2:], -2 * k, axis=1)
        frames.append([y, cb, cr])
    cfg = EncoderConfig(width=w, height=h, qp=30, gop_m=1, rd_candidates=2,
                        search_range=16)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    for f in frames:
        nal, recon = enc.encode_frame(f)
        stream += nal
        recons.append(recon)
    import turingcodec.decode.picture_recon as prmod
    counts = {}
    orig_run = prmod.PictureReconstructor.run
    def patched(self):
        for cu in self.plan.cu_list:
            if cu.pred_mode == 0 and cu.part_mode in (1, 2):
                counts[cu.part_mode] = counts.get(cu.part_mode, 0) + 1
        return orig_run(self)
    prmod.PictureReconstructor.run = patched
    try:
        dec = Decoder()
        out = list(dec.decode_stream(stream))
    finally:
        prmod.PictureReconstructor.run = orig_run
    assert len(out) == 3 and not dec.violations
    for f, recon in zip(out, recons):
        assert f.hash_ok
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)
    assert sum(counts.values()) > 0, "SMP partitions never selected"


def test_amp_partitions_roundtrip():
    """Asymmetric motion partitions (2NxnU/D, nLx2N/nRx2N): decode must
    equal encoder recon and AMP shapes must actually be selected."""
    rng = np.random.default_rng(17)
    w, h = 192, 128
    base = rng.integers(0, 256, (h, w)).astype(np.uint8)
    cb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    cr = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    frames = []
    for k in range(3):
        # motion boundary at y=24: a quarter split (2NxnD) of the 32-CUs
        # covering rows 0..31, off every symmetric PU boundary
        y = base.copy()
        y[:24, :] = np.roll(base[:24, :], 3 * k, axis=1)
        y[24:, :] = np.roll(base[24:, :], -2 * k, axis=1)
        frames.append([y, cb, cr])
    cfg = EncoderConfig(width=w, height=h, qp=30, gop_m=1, rd_candidates=3,
                        search_range=16, amp=True)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    for f in frames:
        nal, recon = enc.encode_frame(f)
        stream += nal
        recons.append(recon)
    import turingcodec.decode.picture_recon as prmod
    counts = {}
    orig_run = prmod.PictureReconstructor.run
    def patched(self):
        for cu in self.plan.cu_list:
            if cu.pred_mode == 0 and cu.part_mode >= 4:
                counts[cu.part_mode] = counts.get(cu.part_mode, 0) + 1
        return orig_run(self)
    prmod.PictureReconstructor.run = patched
    try:
        dec = Decoder()
        out = list(dec.decode_stream(stream))
    finally:
        prmod.PictureReconstructor.run = orig_run
    assert len(out) == 3 and not dec.violations
    for f, recon in zip(out, recons):
        assert f.hash_ok
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)
    assert sum(counts.values()) > 0, "AMP partitions never selected"


@pytest.mark.parametrize("grid", [(2, 2), (3, 1)])
def test_tiles_roundtrip(grid):
    """Tile-grid encode (beyond the reference encoder, which only decodes
    tiles): per-tile CABAC init + entry points, decode must equal the
    encoder recon bit-exactly (hash SEI checked by the Decoder)."""
    cols, rows = grid
    w, h = 320, 192
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=1,
                        search_range=16, wpp=False,
                        tile_cols=cols, tile_rows=rows)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    base = _synthetic_frame(w, h, 7)
    for i in range(3):
        f = [np.roll(p, i * 3, axis=1) for p in base]
        nal, recon = enc.encode_frame(f)
        stream += nal
        recons.append(recon)
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 3
    assert dec.hash_failures == 0
    for f, recon in zip(frames, recons):
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)


def test_tiles_require_no_wpp():
    with pytest.raises(ValueError):
        Encoder(EncoderConfig(width=128, height=64, tile_cols=2, wpp=True))


def test_tskip_roundtrip():
    """--tskip analogue: 4x4 transform-skip RD trials. Sharp synthetic
    content makes TS win on some blocks; the stream must round-trip
    bit-exactly (and actually contain TS flags)."""
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=2,
                        search_range=16, tskip=True)
    enc = Encoder(cfg)
    stream = enc.headers()
    rng = np.random.default_rng(11)
    # screen-content-ish: flat areas + hard edges + sparse impulses
    base = np.full((h, w), 60, np.int16)
    base[:, ::7] = 220
    base[::5, :] = 30
    imp = rng.integers(0, 255, (h, w))
    base = np.where(rng.random((h, w)) < 0.02, imp, base).astype(np.int16)
    fr = [base,
          np.full((h // 2, w // 2), 110, np.int16),
          np.full((h // 2, w // 2), 140, np.int16)]
    recons = []
    for i in range(2):
        f = [np.roll(p, i, axis=1) for p in fr]
        nal, recon = enc.encode_frame(f)
        stream += nal
        recons.append(recon)
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 2
    for f, recon in zip(frames, recons):
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)
    # the feature must actually fire on this content: hook the picture
    # encoder and check the plan's TS map
    import turingcodec.encode.intra_search as IS
    captured = []
    orig_ep = IS.IntraPictureEncoder.encode_picture

    def hooked(self, orig, slice_number=0):
        r = orig_ep(self, orig, slice_number)
        captured.append(r[0])
        return r

    IS.IntraPictureEncoder.encode_picture = hooked
    try:
        enc2 = Encoder(cfg)
        enc2.headers()
        enc2.encode_frame(fr)
    finally:
        IS.IntraPictureEncoder.encode_picture = orig_ep
    assert captured and captured[0].transform_skip_y.sum() > 0


def test_hrd_timing_sei():
    """buffering_period at the IRAP + per-AU pic_timing CPB/DPB delays
    (D.2.2/D.2.3 HRD sections; beyond-reference --hrd-sei)."""
    w, h = 64, 64
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_m=4,
                        rd_candidates=1, bitrate=200000,
                        sei_hrd_timing=True, frame_rate=25.0)
    enc = Encoder(cfg)
    stream = enc.headers()
    n = 6
    for i in range(n):
        for (_idx, nal, _r) in enc.push_frame(_synthetic_frame(w, h, i)):
            stream += nal
    for (_idx, nal, _r) in enc.flush():
        stream += nal
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == n and not dec.violations
    from turingcodec.bitstream.reader import (remove_emulation_prevention,
                                                  split_nal_units)
    from turingcodec.hevc import sei as S
    bps, pts = [], []
    for (s, e) in split_nal_units(stream):
        nal = stream[s:e]
        nut = (nal[0] >> 1) & 0x3F
        if nut != 39:  # PREFIX_SEI
            continue
        for m in S.parse_sei_rbsp(remove_emulation_prevention(nal[2:])):
            if m.payload_type == S.SEI_BUFFERING_PERIOD:
                bps.append(S.parse_buffering_period(m.payload))
            elif m.payload_type == S.SEI_PIC_TIMING:
                pts.append(S.parse_pic_timing(m.payload, frame_field=False,
                                              cpb_dpb_delays=True))
    assert len(bps) == 1  # one IRAP
    assert bps[0]["nal_initial_cpb_removal_delay"][0] > 0
    assert len(pts) == n  # one per AU
    # decode-order CPB removal deltas since the BP AU (minus1 form): the
    # IRAP clamps to 0, then 1-1, 2-1, ... per following AU
    deltas = [p["au_cpb_removal_delay_minus1"] for p in pts]
    assert deltas == [0] + list(range(n - 1))
    # output order: every dpb_output_delay >= 0 and the IRAP waits for
    # the reorder depth
    assert pts[0]["pic_dpb_output_delay"] == cfg.gop_m - 1
    assert all(p["pic_dpb_output_delay"] >= 0 for p in pts)


def test_pts_dts_timing():
    """PTS/DTS assignment (InputQueue.cpp:386-405 analogue): dts of the
    n-th picture in decode order = pts of input n-3, 90 kHz clock; dts
    strictly increasing in decode order and <= pts."""
    w, h = 64, 64
    cfg = EncoderConfig(width=w, height=h, qp=32, gop_m=4,
                        rd_candidates=1, frame_rate=25.0)
    enc = Encoder(cfg)
    order = []
    for i in range(9):
        for (idx, _nal, _r) in enc.push_frame(_synthetic_frame(w, h, i)):
            order.append(idx)
    for (idx, _nal, _r) in enc.flush():
        order.append(idx)
    assert sorted(order) == list(range(9))
    period = 90000.0 / 25.0
    times = [enc.timing(i) for i in order]
    assert times[0][2] == 1 and all(t[2] == 0 for t in times[1:])
    for n, (pts, dts, _k) in enumerate(times):
        assert pts == round(order[n] * period)
        assert dts == round((n - 3) * period)
        assert dts <= pts
    dtss = [t[1] for t in times]
    assert dtss == sorted(dtss)


def test_inter_rqt_roundtrip():
    """Inter one-level RQT (Speed.h useRqt, slow preset): the encoder may
    split 16x16/32x32 inter TUs; stream signals
    max_transform_hierarchy_depth_inter=1 and decodes to the encoder
    recon bit-exactly."""
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, qp=27, rd_candidates=3,
                        search_range=16)
    enc = Encoder(cfg)
    assert enc.sps.max_transform_hierarchy_depth_inter == 1
    stream = enc.headers()
    rng = np.random.default_rng(7)
    base = _synthetic_frame(w, h, 5)
    # high-detail patch so inter residuals favor a TU split somewhere
    base[0][8:40, 8:40] = rng.integers(0, 256, (32, 32))
    recons = []
    for i in range(3):
        f = [np.roll(p, i * 3, axis=1) for p in base]
        nal, recon = enc.encode_frame(f)
        stream += nal
        recons.append(recon)
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 3 and not dec.violations
    for f, recon in zip(frames, recons):
        for a, b in zip(f.planes, recon):
            np.testing.assert_array_equal(a, b)
    # the feature actually fires: some inter CU carries a split TU tree
    plan = enc._last_plan
    inter = plan.cu_pred_mode == 0
    split = inter & (plan.tu_log2 < plan.cu_size_log2) & (plan.cu_id >= 0)
    assert split.any(), "no inter CU chose the split transform tree"


def test_rate_control_intra_complexity():
    """EstimateIntraComplexity feeds the IDR allocation: complex content
    gets a larger intra target than flat content at the same bitrate."""
    from turingcodec.encode.rate_control import (SequenceRateController,
                                                     intra_complexity)
    rng = np.random.default_rng(5)
    flat = np.full((64, 64), 128, np.int16)
    busy = rng.integers(0, 256, (64, 64)).astype(np.int16)
    c_flat = intra_complexity(flat)
    c_busy = intra_complexity(busy)
    assert c_flat == 0 and c_busy > 0
    rc1 = SequenceRateController(200000, 25.0, 64, 64)
    rc2 = SequenceRateController(200000, 25.0, 64, 64)
    _, _, bits_flat = rc1.pre_picture(True, 0, intra_cost=c_flat)
    _, _, bits_busy = rc2.pre_picture(True, 0, intra_cost=c_busy)
    assert bits_busy > bits_flat
    # end-to-end: a rate-controlled encode with the pre-analysis runs
    cfg = EncoderConfig(width=64, height=64, qp=32, gop_m=1,
                        bitrate=100000, frame_rate=25.0)
    enc = Encoder(cfg)
    stream = enc.headers()
    for i in range(3):
        for (_idx, nal, _r) in enc.push_frame(_synthetic_frame(64, 64, i)):
            stream += nal
    for (_idx, nal, _r) in enc.flush():
        stream += nal
    frames = list(Decoder().decode_stream(stream))
    assert len(frames) == 3
