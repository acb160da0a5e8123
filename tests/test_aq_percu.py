"""Per-CU adaptive quantization (diff_cu_qp_delta_depth > 0).

The reference signals diff_cu_qp_delta_depth = --aq-depth and queries
per-CU offsets from an activity pyramid during the search
(ref:turing/Encoder.cpp:734-738, AdaptiveQuantisation.h:101,
Search.hpp:1135-1151). Our QG machinery in the writers
(ref parity: write_core.cpp w_derive_qp) and decoder was always
generic; these tests pin the search-side per-CU assignment:
  - native and pure-Python searchers byte-identical,
  - streams decode hash-clean in our decoder,
  - the reference decoder reproduces the identical YUV,
  - sub-CTB deltas actually appear (the map isn't flat).
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
        if len(out) >= 5:
            break
        out.append([np.asarray(p) for p in f.planes])
    return out


def _encode(frames, depth, env=None, gop_m=1):
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        cfg = EncoderConfig(width=640, height=360, qp=32, rd_candidates=1,
                            search_range=32, gop_m=gop_m, sao=False,
                            aq_strength=1.0, aq_depth=depth)
        enc = Encoder(cfg)
        out = [enc.headers()]
        plans = []
        for f in frames:
            for (_i, nal, _r) in enc.push_frame([p.copy() for p in f]):
                out.append(nal)
                plans.append(enc._last_plan)
        for (_i, nal, _r) in enc.flush():
            out.append(nal)
            plans.append(enc._last_plan)
        return b"".join(out), plans
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_percu_aq_roundtrip_and_twin_parity(frames):
    bs, plans = _encode(frames, 2)
    # sub-CTB QP variation exists (the pyramid isn't flat on this content)
    varied = any(
        len(np.unique(p.qp_y[:, :])) > 1 and any(
            len(np.unique(p.qp_y[ry * 16:(ry + 1) * 16,
                                 rx * 16:(rx + 1) * 16])) > 1
            for ry in range(p.qp_y.shape[0] // 16)
            for rx in range(p.qp_y.shape[1] // 16))
        for p in plans)
    assert varied, "no sub-CTB dQP was signalled — depth had no effect"
    # decodes hash-clean in our decoder
    dec = Decoder()
    n = sum(1 for _ in dec.decode_stream(bs))
    assert n == len(frames) and dec.hash_failures == 0
    # pure-Python twin byte-identical
    bs_py, _ = _encode(frames, 2, {"TURING_NO_NATIVE": "1"})
    assert bs_py == bs
    # depth 0 (per-CTB) still its own distinct stream
    bs0, _ = _encode(frames, 0)
    assert bs0 != bs


@pytest.mark.parametrize("depth,wpp", [(0, True), (2, True), (0, False)])
def test_reference_aq_stream_conformance(frames, tmp_path, depth, wpp):
    """Decode the reference encoder's own --aq streams bit-exact (this
    caught two real conformance bugs: cu_qp_delta placement at 4x4
    chroma-only groups, and the per-CU — non-retroactive — QpY
    derivation of pre-delta CUs in a quantization group)."""
    if not os.path.exists(REF_BIN):
        pytest.skip("reference binary not built")
    yuv = tmp_path / "in.yuv"
    with open(yuv, "wb") as fh:
        for f in frames:
            for p in f:
                fh.write(np.asarray(p).astype(np.uint8).tobytes())
    bs = tmp_path / "refaq.hevc"
    cmd = [REF_BIN, "encode", "--input-res", "640x360", "--frames",
           str(len(frames)), "--frame-rate", "24", "--qp", "32",
           "--speed", "fast", "--max-gop-m", "1", "--threads", "1",
           "--aq", "--aq-depth", str(depth), "--aq-range", "6",
           "-o", str(bs), str(yuv)]
    if not wpp:
        cmd.insert(-3, "--no-wpp")
    r = subprocess.run(cmd, capture_output=True)
    assert r.returncode == 0, r.stderr[-300:]
    ryuv = tmp_path / "ref.yuv"
    subprocess.run([REF_BIN, "decode", str(bs), "-o", str(ryuv)],
                   capture_output=True, check=True)
    md5_ref = hashlib.md5(ryuv.read_bytes()).hexdigest()
    md5_ours = hashlib.md5()
    for f in Decoder().decode_stream(bs.read_bytes()):
        for pl in f.planes:
            md5_ours.update(np.asarray(pl).astype(np.uint8).tobytes())
    assert md5_ours.hexdigest() == md5_ref


def test_percu_aq_reference_decoder(frames, tmp_path):
    if not os.path.exists(REF_BIN):
        pytest.skip("reference binary not built")
    bs, _ = _encode(frames, 2, gop_m=4)
    p = tmp_path / "aq.hevc"
    p.write_bytes(bs)
    yuv = tmp_path / "aq.yuv"
    r = subprocess.run([REF_BIN, "decode", str(p), "-o", str(yuv)],
                       capture_output=True)
    assert r.returncode == 0, r.stderr[-400:]
    md5_ref = hashlib.md5(yuv.read_bytes()).hexdigest()
    md5_ours = hashlib.md5()
    for f in Decoder().decode_stream(bs):
        for pl in f.planes:
            md5_ours.update(np.asarray(pl).astype(np.uint8).tobytes())
    assert md5_ours.hexdigest() == md5_ref
