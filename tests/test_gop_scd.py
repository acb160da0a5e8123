"""GOP sizes 3/5/6/7 (InputQueue.cpp:331-379 SOP tables) and the
lookahead shot-change detector (SCDetection.h parity)."""
import subprocess

import numpy as np
import pytest

from turingcodec.decode.decoder import Decoder
from turingcodec.encode.encoder import EncoderConfig, Encoder

REF_BIN = "/tmp/turing-dbg/turing/turing"


def _frames(n, w, h, seed=5, cut_at=None):
    rng = np.random.RandomState(seed)
    if cut_at is None:
        base = rng.randint(0, 256, (h + 32, w + 32)).astype(np.int16)
        alt = base
    else:
        # a real scene change needs distinct luma DISTRIBUTIONS (the
        # detector is histogram-based, SCDetection.h) — gradient scenes
        base = np.add.outer(np.arange(h + 32), np.arange(w + 32)) \
            .astype(np.int16) % 200
        alt = (255 - base // 2).astype(np.int16)
    out = []
    for i in range(n):
        src = alt if (cut_at is not None and i >= cut_at) else base
        # static scenes for the cut tests: the dhist spike at the cut then
        # stands alone in a quiet window and trips the hard threshold;
        # smooth content pans monotonically (no wrap-around jumps)
        o = 0 if cut_at is not None else min(i, 32)
        out.append([np.ascontiguousarray(src[o:o + h, o:o + w]),
                    np.ascontiguousarray(src[:h // 2, :w // 2]),
                    np.ascontiguousarray(src[16:16 + h // 2, :w // 2])])
    return out


def _encode(frames, w, h, **kw):
    cfg = EncoderConfig(width=w, height=h, qp=34, sao=False, **kw)
    enc = Encoder(cfg)
    out = [enc.headers()]
    idxs = []
    for f in frames:
        for (i, nal, _r) in enc.push_frame([p.copy() for p in f]):
            out.append(nal)
            idxs.append(i)
    for (i, nal, _r) in enc.flush():
        out.append(nal)
        idxs.append(i)
    return b"".join(out), idxs, enc


@pytest.mark.parametrize("gop_m", [3, 5, 6, 7])
def test_gop_sizes_roundtrip(gop_m, tmp_path):
    n = gop_m * 2 + 1
    frames = _frames(n, 96, 64)
    bs, idxs, _ = _encode(frames, 96, 64, gop_m=gop_m)
    assert sorted(idxs) == list(range(n))
    dec = Decoder()
    got = sum(1 for _ in dec.decode_stream(bs))
    assert got == n and dec.hash_failures == 0
    # cross-validate against the reference decoder
    p = tmp_path / "g.hevc"
    p.write_bytes(bs)
    r = subprocess.run([REF_BIN, "decode", str(p), "-o",
                        str(tmp_path / "g.yuv")], capture_output=True)
    assert r.returncode == 0, r.stderr[-400:]
    assert f"decoded: {n} pictures".encode() in r.stdout + r.stderr


def test_scd_lookahead_idr_on_cut():
    cut = 13
    frames = _frames(30, 96, 64, cut_at=cut)
    bs, idxs, enc = _encode(frames, 96, 64, gop_m=4, shot_change=True,
                            hash_type=None)
    assert enc._scd.is_shot_change(cut)
    # the cut input must be encoded as an IDR (nal types 19/20) and every
    # input must come out exactly once
    assert sorted(idxs) == list(range(30))
    dec = Decoder()
    pocs_idr = []
    n = 0
    for f in dec.decode_stream(bs):
        n += 1
    assert n == 30
    # count IDR NALs in the stream: one for input 0, one for the cut
    import re
    starts = [m.start() for m in re.finditer(b"\x00\x00\x01", bs)]
    nuts = [(bs[s + 3] >> 1) & 0x3F for s in starts]
    idrs = sum(1 for t in nuts if t in (19, 20))
    assert idrs == 2, (idrs, nuts)


def test_scd_no_false_cut_on_smooth_content():
    frames = _frames(24, 96, 64)
    _bs, _idxs, enc = _encode(frames, 96, 64, gop_m=4, shot_change=True,
                              hash_type=None)
    assert not any(enc._scd.flags.values()), enc._scd.flags
