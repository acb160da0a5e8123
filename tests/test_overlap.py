"""Inter-picture overlap (concurrent dependent pictures).

The reference overlaps dependent pictures with a CTU-granular wavefront:
a CTU encodes once each reference picture's loop filter has passed
(rx+4, ry+3) (ref:turing/TaskEncodeSubstream.cpp:71-93,
ref:turing/Global.h:1561-1562), with LimitFullPelMv bounding the search's
downward reach (ref:turing/Search.hpp:1366-1408). Our row-granular
equivalent (EncoderConfig.frame_overlap) must be:
  - byte-identical at any in-flight picture count (the MV y-clamp and all
    candidate gates are static functions of the CTU position);
  - a legal stream: our decoder's hash-SEI check passes and the reference
    decoder produces the identical YUV.
"""
import hashlib
import os
import subprocess

import numpy as np
import pytest

from turingcodec.decode.decoder import Decoder
from turingcodec.encode.encoder import EncoderConfig, Encoder

REF_BIN = "/tmp/turing-dbg/turing/turing"


@pytest.fixture(scope="module")
def frames(caminandes_bytes):
    dec = Decoder()
    out = []
    for f in dec.decode_stream(caminandes_bytes):
        if len(out) >= 9:
            break
        out.append([np.asarray(p) for p in f.planes])
    return out


def _encode(frames, ft, gop_m=1, **kw):
    os.environ["TURING_FRAME_THREADS"] = str(ft)
    try:
        base = dict(width=640, height=360, qp=32, rd_candidates=1,
                    search_range=32, gop_m=gop_m, sao=False,
                    rdoq=True, sdh=True, frame_overlap=True)
        base.update(kw)
        cfg = EncoderConfig(**base)
        enc = Encoder(cfg)
        out = [enc.headers()]
        for f in frames:
            for (_i, nal, _r) in enc.push_frame([p.copy() for p in f]):
                out.append(nal)
        for (_i, nal, _r) in enc.flush():
            out.append(nal)
        return b"".join(out)
    finally:
        del os.environ["TURING_FRAME_THREADS"]


@pytest.fixture(scope="module")
def ldp_stream(frames):
    return _encode(frames, 2)


def test_overlap_in_flight_invariance_ldp(frames, ldp_stream):
    """The low-delay chain — zero overlap under plain frame batching — is
    the workload the wavefront exists for; 1/2/4 pictures in flight must
    be byte-identical."""
    assert _encode(frames, 1) == ldp_stream
    assert _encode(frames, 4) == ldp_stream


def test_overlap_stream_decodes(frames, ldp_stream):
    dec = Decoder()
    n = 0
    for f in dec.decode_stream(ldp_stream):
        assert f.hash_ok is not False
        n += 1
    assert n == len(frames) and dec.hash_failures == 0


def test_overlap_hierarchical_b(frames):
    """Hierarchical-B GOPs mix in-window dependencies (leaf B references
    anchor being encoded) with complete refs; in-flight count must not
    change a bit, and the stream must decode hash-clean."""
    a = _encode(frames, 1, gop_m=4)
    b = _encode(frames, 3, gop_m=4)
    assert a == b
    dec = Decoder()
    n = sum(1 for _ in dec.decode_stream(a))
    assert n == len(frames) and dec.hash_failures == 0


def test_overlap_reference_decoder(ldp_stream, tmp_path):
    """The reference decoder reproduces our decoder's YUV exactly —
    covers the banded deblock publisher (any band-sequencing error would
    desync the reference chain and the reconstructions)."""
    if not os.path.exists(REF_BIN):
        pytest.skip("reference binary not built")
    p = tmp_path / "ovl.hevc"
    p.write_bytes(ldp_stream)
    yuv = tmp_path / "ovl.yuv"
    r = subprocess.run([REF_BIN, "decode", str(p), "-o", str(yuv)],
                       capture_output=True)
    assert r.returncode == 0, r.stderr[-400:]
    md5_ref = hashlib.md5(yuv.read_bytes()).hexdigest()
    md5_ours = hashlib.md5()
    for f in Decoder().decode_stream(ldp_stream):
        for pl in f.planes:
            md5_ours.update(np.asarray(pl).astype(np.uint8).tobytes())
    assert md5_ours.hexdigest() == md5_ref


def test_overlap_sao(frames, tmp_path):
    """SAO under overlap: the follower estimates + applies SAO one CTB
    row behind the deblock band (the reference wavefront's saoed()
    rule). In-flight invariance, hash-clean decode, and the reference
    decoder reproduces the identical YUV."""
    a = _encode(frames, 1, sao=True)
    assert _encode(frames, 3, sao=True) == a
    dec = Decoder()
    n = sum(1 for _ in dec.decode_stream(a))
    assert n == len(frames) and dec.hash_failures == 0
    if os.path.exists(REF_BIN):
        p = tmp_path / "os.hevc"
        p.write_bytes(a)
        yuv = tmp_path / "os.yuv"
        r = subprocess.run([REF_BIN, "decode", str(p), "-o", str(yuv)],
                           capture_output=True)
        assert r.returncode == 0, r.stderr[-300:]
        md5_ref = hashlib.md5(yuv.read_bytes()).hexdigest()
        md5_ours = hashlib.md5()
        for f in Decoder().decode_stream(a):
            for pl in f.planes:
                md5_ours.update(np.asarray(pl).astype(np.uint8).tobytes())
        assert md5_ours.hexdigest() == md5_ref


def test_overlap_rate_control_rendezvous(frames):
    """Picture-level rate control under overlap: the fixed finalize
    schedule makes prepare(i) see exactly the pictures <= i-4 finalized
    (the reference's RC feedback lag under --concurrent-frames,
    RateControl.cpp:849). Deterministic run-to-run, decodes clean, and
    lands near the CBR target."""
    def enc():
        cfg = EncoderConfig(width=640, height=360, qp=32, rd_candidates=1,
                            search_range=32, gop_m=1, sao=False,
                            bitrate=400_000, ctu_rc=False,
                            frame_overlap=True)
        e = Encoder(cfg)
        out = [e.headers()]
        for f in frames:
            for (_i, nal, _r) in e.push_frame([p.copy() for p in f]):
                out.append(nal)
        for (_i, nal, _r) in e.flush():
            out.append(nal)
        return b"".join(out)

    a = enc()
    assert a == enc()
    dec = Decoder()
    n = sum(1 for _ in dec.decode_stream(a))
    assert n == len(frames) and dec.hash_failures == 0
    target = 400_000 / 24.0 * len(frames) / 8.0
    assert 0.5 * target < len(a) < 2.0 * target


def test_deblock_band_sequence_equals_whole(frames):
    """DeblockNative banded pass == whole-picture pass, sample-exact, on
    a real encoded picture's plan (the overlap follower's publisher
    contract)."""
    from turingcodec import native
    if native.get_lib() is None:
        pytest.skip("native core unavailable")
    cfg = EncoderConfig(width=640, height=360, qp=32, rd_candidates=1,
                        search_range=32, gop_m=1, sao=False)
    # drive the internals directly: prepare+search the second (inter)
    # picture, then deblock its search recon twice — banded vs whole
    enc = Encoder(cfg)
    enc._inputs[0] = [p.copy() for p in frames[0]]
    [d0] = enc._planner.push(False)
    j0 = enc._docket_prepare(d0)
    enc._docket_encode(j0)
    enc._docket_finalize(j0)
    enc._inputs[1] = [p.copy() for p in frames[1]]
    [d1] = enc._planner.push(False)
    j1 = enc._docket_prepare(d1)
    plan, srec = j1.enc.encode_picture(j1.yuv)
    whole = [p.copy() for p in srec]
    db = native.DeblockNative.try_create(plan, enc.geom, *whole)
    assert db is not None
    db.run()
    banded = [p.copy() for p in srec]
    db2 = native.DeblockNative.try_create(plan, enc.geom, *banded)
    S, H = enc.sps.ctb_size_y, enc.sps.pic_height_in_luma_samples
    hc = enc.sps.pic_height_in_ctbs_y
    e = 0
    for r in range(hc):
        y1 = min((r + 1) * S, H)
        ey1 = H if r == hc - 1 else y1 - 4
        db2.run_band(r * S, y1, e, ey1)
        e = ey1
    for a, b in zip(whole, banded):
        assert np.array_equal(a, b)
