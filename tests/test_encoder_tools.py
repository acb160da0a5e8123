"""Tests for rate control, AQ, and shot-change IDR placement."""
import numpy as np
import pytest

from turingcodec.decode.decoder import Decoder
from turingcodec.encode.encoder import Encoder, EncoderConfig
from tests.test_encoder import _synthetic_frame


def test_aq_roundtrip():
    cfg = EncoderConfig(width=128, height=64, qp=32, rd_candidates=1,
                        aq_strength=1.0, gop_m=1, search_range=8)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    for i in range(3):
        f = [np.roll(p, i, axis=1) for p in _synthetic_frame(128, 64, 2)]
        f[0][:, :40] //= 4   # non-uniform activity -> real dQPs
        _, nal, recon = enc.push_frame(f)[0]
        stream += nal
        recons.append(recon)
    frames = list(Decoder().decode_stream(stream))
    for f, r in zip(frames, recons):
        assert f.hash_ok
        for a, b in zip(f.planes, r):
            np.testing.assert_array_equal(a, b)


def test_rate_control_converges():
    w, h = 128, 64
    target = 200_000.0
    cfg = EncoderConfig(width=w, height=h, qp=32, rd_candidates=1, gop_m=1,
                        bitrate=target, frame_rate=24.0, hash_type=None,
                        search_range=8)
    enc = Encoder(cfg)
    rng = np.random.default_rng(0)
    bits = 0
    n = 12
    base = _synthetic_frame(w, h, 5)
    for i in range(n):
        f = [np.clip(p + rng.integers(-3, 4, p.shape), 0, 255).astype(np.int16)
             for p in base]
        for r in enc.push_frame(f):
            bits += 8 * len(r[1])
    achieved = bits * 24.0 / n
    assert 0.5 * target < achieved < 2.0 * target, achieved


def test_shot_change_places_idr():
    # the reference-parity detector (SCDetection.h) needs a dhist window
    # of 10 transitions around the cut — static scenes trip its hard
    # threshold (tests/test_gop_scd.py covers the lookahead placement)
    from turingcodec.hevc import types as T
    from turingcodec.bitstream.reader import iter_nal_units

    cfg = EncoderConfig(width=64, height=64, qp=35, rd_candidates=1,
                        gop_m=1, shot_change=True, search_range=8,
                        hash_type=None)
    enc = Encoder(cfg)
    stream = enc.headers()
    n = 24
    cut = 11
    a = _synthetic_frame(64, 64, 0)
    b = _synthetic_frame(64, 64, 99)
    b[0][:] = 255 - b[0]
    for i in range(n):
        f = a if i < cut else b
        for r in enc.push_frame([p.copy() for p in f]):
            stream += r[1]
    for r in enc.flush():
        stream += r[1]
    idr_count = sum(1 for nal in iter_nal_units(stream)
                    if T.is_idr(nal.nal_unit_type))
    assert idr_count == 2, idr_count
    # and the stream still decodes
    frames = list(Decoder().decode_stream(stream))
    assert len(frames) == n


def test_field_coding_roundtrip():
    """Field coding: each frame becomes two half-height field pictures with
    pic_timing pic_struct 1/2, VUI field_seq_flag, interlaced PTL flags
    (the reference's --field-coding, encode.cpp:379-453)."""
    from turingcodec.hevc import sei as S
    w, h = 64, 64
    cfg = EncoderConfig(width=w, height=h, qp=35, rd_candidates=1, gop_m=1,
                        search_range=8, field_coding=True)
    enc = Encoder(cfg)
    stream = enc.headers()
    base = _synthetic_frame(w, h, 3)
    recons = {}
    for i in range(2):
        f = [np.roll(p, i, axis=1) for p in base]
        for idx, nal, rec in enc.push_frame(f):
            stream += nal
            recons[idx] = rec
    for idx, nal, rec in enc.flush():
        stream += nal
        recons[idx] = rec
    assert len(recons) == 4  # two fields per frame
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 4 and not dec.violations
    for f in frames:
        assert f.planes[0].shape == (h // 2, w)
        assert f.hash_ok
    sps = list(dec.ps.sps.values())[0]
    assert sps.vui.field_seq_flag == 1
    assert sps.ptl.general_interlaced_source_flag == 1
    assert sps.ptl.general_progressive_source_flag == 0
    structs = [d["pic_struct"] for t, d in dec.sei_log
               if t == S.SEI_PIC_TIMING]
    assert structs == [1, 2, 1, 2]
    # decode == encoder recon, field pictures in input order == poc order
    for i, f in enumerate(frames):
        for a, b in zip(f.planes, recons[i]):
            np.testing.assert_array_equal(a, b)


def test_hrd_signalling():
    """CBR rate control writes VUI hrd_parameters (nal_hrd, cbr, 1s CPB);
    the decoder parses them back (spec E.2.2 round trip)."""
    cfg = EncoderConfig(width=64, height=64, qp=35, rd_candidates=1,
                        gop_m=1, search_range=8, bitrate=100_000,
                        frame_rate=25.0)
    enc = Encoder(cfg)
    stream = enc.headers()
    f = _synthetic_frame(64, 64, 7)
    for i in range(3):
        for r in enc.push_frame([np.roll(p, i, axis=0) for p in f]):
            stream += r[1]
    dec = Decoder()
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 3 and not dec.violations
    sps = list(dec.ps.sps.values())[0]
    hrd = sps.vui.hrd
    assert hrd is not None and hrd.nal_hrd_parameters_present_flag == 1
    sl = hrd.sub_layers[0]
    e = sl["nal_hrd"][0]
    assert e["cbr_flag"] == 1
    assert (e["bit_rate_value_minus1"] + 1) << (6 + hrd.bit_rate_scale) \
        == 99840  # 100 kb/s quantized to 256-bit units
    assert sl["fixed_pic_rate_general_flag"] == 1


def test_frame_parallel_bit_identical():
    """Frame-parallel encoding (2 in-flight pictures, per-picture native
    contexts) must reproduce the sequential walk byte-exactly — the
    reference's concurrent-frames determinism contract
    (TaskEncodeInput.cpp:41-52 + its signature threads-1 row)."""
    import os
    import hashlib
    import numpy as np
    from turingcodec.encode.encoder import EncoderConfig, Encoder

    rng = np.random.default_rng(3)
    h, w = 96, 160
    prev = rng.integers(0, 255, (h + 64, w + 64), np.int16)
    frames = []
    for i in range(9):
        y = np.ascontiguousarray(prev[i * 2:i * 2 + h, i * 3:i * 3 + w])
        frames.append([y, np.full((h // 2, w // 2), 100, np.int16),
                       np.full((h // 2, w // 2), 120, np.int16)])

    def run(ft):
        old = os.environ.get("TURING_FRAME_THREADS")
        os.environ["TURING_FRAME_THREADS"] = ft
        try:
            cfg = EncoderConfig(width=w, height=h, qp=32, gop_m=8,
                                rd_candidates=2)
            enc = Encoder(cfg)
            out = [enc.headers()]
            for fr in frames:
                for (_i, nal, _r) in enc.push_frame(
                        [p.copy() for p in fr]):
                    out.append(nal)
            for (_i, nal, _r) in enc.flush():
                out.append(nal)
            return hashlib.md5(b"".join(out)).hexdigest()
        finally:
            if old is None:
                del os.environ["TURING_FRAME_THREADS"]
            else:
                os.environ["TURING_FRAME_THREADS"] = old

    assert run("1") == run("2") == run("3")


def test_noise_adaptive_rdoq_persistence():
    """The dense-ME SAD median flips RDOQ to dead-zone quantization only
    after 2+ consecutive unpredictable inter pictures (white noise);
    a single unpredictable picture (a scene cut) keeps RDOQ."""
    import numpy as np
    from turingcodec.encode.encoder import EncoderConfig, Encoder
    import turingcodec.encode.inter_search as IS

    rng = np.random.RandomState(7)
    h, w = 96, 160
    flat = np.full((h, w), 128, np.int16)
    grad = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.int16)

    def noise():
        return np.clip(grad + rng.randint(-24, 25, (h, w)), 0,
                       255).astype(np.int16)

    decisions = []
    orig_na = IS.InterPictureEncoder._noise_adapt

    def probe(self, orig):
        r = orig_na(self, orig)
        decisions.append(self.use_rdoq)
        return r

    IS.InterPictureEncoder._noise_adapt = probe
    try:
        cfg = EncoderConfig(width=w, height=h, qp=32, gop_m=1,
                            search_range=32, rd_candidates=1, rdoq=True,
                            sdh=True)
        enc = Encoder(cfg)
        # frames: IDR(flat), P flat (predictable), P cut-to-noise (one
        # unpredictable), then independent-noise Ps (persistent)
        frames = [flat, flat.copy()] + [noise() for _ in range(4)]
        for y in frames:
            fr = [y, np.full((h // 2, w // 2), 100, np.int16),
                  np.full((h // 2, w // 2), 120, np.int16)]
            for _ in enc.push_frame([p.copy() for p in fr]):
                pass
        for _ in enc.flush():
            pass
    finally:
        IS.InterPictureEncoder._noise_adapt = orig_na

    # decisions cover the 5 inter pictures in order:
    # predictable P -> rdoq on; first noise P (streak 0) -> still on;
    # subsequent noise Ps -> off
    assert decisions[0] is True          # flat P
    assert decisions[1] is True          # scene cut to noise: keep RDOQ
    assert decisions[2] is False         # persistent noise: dead-zone
    assert decisions[3] is False
