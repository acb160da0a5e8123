"""Native (C++) CABAC core parity vs the pure-Python oracles."""
import os

import numpy as np
import pytest

from turingcodec import native

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native cabac core unavailable")

rng = np.random.default_rng(21)


def _random_block(log2, density):
    n = 1 << log2
    blk = np.zeros((n, n), np.int32)
    m = rng.random((n, n)) < density
    blk[m] = rng.integers(-40, 40, m.sum())
    if not blk.any():
        blk[0, 0] = 3
    return blk


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("scan", [0, 1, 2])
@pytest.mark.parametrize("c_idx", [0, 1])
def test_residual_bits_matches_python(log2, scan, c_idx):
    if log2 > 3 and scan > 0:
        pytest.skip("h/v scans only exist for 4x4/8x8")
    from turingcodec.cabac.engine import ContextPool
    from turingcodec.cabac.rate import RateEstimator
    from turingcodec.encode.ctu_write import residual_core

    for density in (0.05, 0.3, 0.9):
        blk = _random_block(log2, density)
        ctx_a = ContextPool()
        ctx_a.initialize(1, 30)
        ctx_b = ctx_a.copy()
        est = RateEstimator(ctx_a)
        residual_core(est, blk, log2, c_idx, scan, False)
        got = native.residual_bits(ctx_b, log2, c_idx, scan, False, blk)
        assert got == pytest.approx(est.bits)
        assert ctx_a.states == ctx_b.states


def test_residual_decode_matches_python():
    """Decode the first frames of the bundled stream with and without the
    native path: outputs and hash verification must be identical."""
    import hashlib
    path = "/root/reference/test/excerpt_(CC)_caminandes.com_640x360.hevc"
    if not os.path.exists(path):
        pytest.skip("reference stream unavailable")
    data = open(path, "rb").read()
    from turingcodec.decode.decoder import Decoder

    def run(limit=3):
        dec = Decoder()
        md5 = hashlib.md5()
        c = 0
        for fr in dec.decode_stream(data):
            for p in fr.planes:
                md5.update(p.astype("uint8").tobytes())
            c += 1
            if c >= limit:
                break
        return md5.hexdigest()

    h_native = run()
    os.environ["TURING_NO_NATIVE"] = "1"
    native._TRIED, native._LIB = False, None
    try:
        h_python = run()
    finally:
        del os.environ["TURING_NO_NATIVE"]
        native._TRIED, native._LIB = False, None
    assert h_native == h_python


def test_satd_simd_matches_scalar():
    """The AVX2 SATD (enc_core satd8/4_avx2) must be bit-identical to the
    scalar Hadamard (satd_block_t), incl. 10-bit-range inputs."""
    import ctypes
    lib = native.get_lib()
    lib.tc_test_satd.restype = ctypes.c_int64
    lib.tc_test_satd.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int]
    lib.tc_test_satd_scalar.restype = ctypes.c_int64
    lib.tc_test_satd_scalar.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int]
    for bs in (4, 8):
        for lo, hi in ((0, 256), (0, 1024)):
            for _ in range(100):
                a = np.ascontiguousarray(
                    rng.integers(lo, hi, (bs, bs)), np.int32)
                b = np.ascontiguousarray(
                    rng.integers(lo, hi, (bs, bs)), np.int32)
                va = lib.tc_test_satd(a.ctypes.data, b.ctypes.data, bs)
                vs = lib.tc_test_satd_scalar(a.ctypes.data, b.ctypes.data,
                                             bs)
                assert va == vs


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("bd", [8, 10])
def test_fwd_transform_folded_matches_oracle(n, bd):
    """Even/odd-folded native forward DCT (and DST4) == numpy oracle."""
    import ctypes
    from turingcodec.ops.transform import forward_transform_np
    lib = native.get_lib()
    lib.tc_test_fwd_transform.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    hi = (1 << bd) - 1
    for use_dst in ([0, 1] if n == 4 else [0]):
        for _ in range(25):
            res = np.ascontiguousarray(
                rng.integers(-hi, hi + 1, (n, n)), np.int32)
            out = np.zeros((n, n), np.int32)
            lib.tc_test_fwd_transform(res.ctypes.data, n, bd, use_dst,
                                      out.ctypes.data)
            ref = np.asarray(forward_transform_np(res, bd, bool(use_dst)),
                             np.int32)
            assert np.array_equal(out, ref)


def test_wpp_row_threads_bit_identical():
    """Wavefront row threading (tc_enc_picture nthreads>1) produces the
    byte-identical bitstream and reconstruction as the sequential walk —
    the analogue of the reference signature rows sharing one expected hash
    across thread counts (signature.cpp:228-237)."""
    import hashlib

    from turingcodec.encode.encoder import (EncoderConfig,
                                                encode_yuv_stream)
    if native.get_lib() is None:
        pytest.skip("native core unavailable")
    rng2 = np.random.default_rng(7)
    w, h = 192, 192  # 3x3 CTUs: enough rows for a real wavefront
    n_frames = 4
    base = rng2.integers(0, 256, (h, w), np.int32)
    frames = []
    for i in range(n_frames):
        y = np.clip(np.roll(base, (2 * i, 3 * i), (0, 1))
                    + rng2.integers(-4, 5, (h, w)), 0, 255)
        u = np.clip(rng2.integers(100, 156, (h // 2, w // 2)), 0, 255)
        frames.append(y.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes())
    raw = b"".join(frames)
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=1,
                        search_range=32, sdh=False)
    results = {}
    old = os.environ.get("TURING_ENC_THREADS")
    try:
        for t in (1, 3):
            os.environ["TURING_ENC_THREADS"] = str(t)
            bs, md5 = encode_yuv_stream(raw, cfg, n_frames=n_frames)
            results[t] = (hashlib.md5(bs).hexdigest(), md5)
    finally:
        if old is None:
            os.environ.pop("TURING_ENC_THREADS", None)
        else:
            os.environ["TURING_ENC_THREADS"] = old
    assert results[1] == results[3]


def test_native_python_encoder_bit_identical():
    """The native CTU search (enc_core.cpp, incl. the lowres pre-ME seeded
    raster replacement) and the pure-Python searcher produce byte-identical
    bitstreams on content with large motion (forces the far-winner path)."""
    import hashlib

    from turingcodec.encode.encoder import (EncoderConfig,
                                                encode_yuv_stream)
    if native.get_lib() is None:
        pytest.skip("native core unavailable")
    rng2 = np.random.default_rng(11)
    w, h = 192, 128
    n_frames = 3
    base = rng2.integers(0, 256, (2 * h, 2 * w), np.int32)
    frames = []
    for i in range(n_frames):
        # 14 px/frame pan: far beyond the MET probes, so the star's first
        # pass wins from far out and the lowres seeds are consulted
        y = base[h // 2 + 14 * i:h // 2 + 14 * i + h,
                 w // 2 + 9 * i:w // 2 + 9 * i + w]
        u = np.full((h // 2, w // 2), 128)
        frames.append(y.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes())
    raw = b"".join(frames)
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=1,
                        search_range=32, sdh=False, met=True)
    bs_nat, md5_nat = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    os.environ["TURING_NO_NATIVE_ENC"] = "1"
    try:
        bs_py, md5_py = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    finally:
        del os.environ["TURING_NO_NATIVE_ENC"]
    assert md5_nat == md5_py
    assert hashlib.md5(bs_nat).hexdigest() == hashlib.md5(bs_py).hexdigest()


def test_native_python_encoder_rqt_bit_identical():
    """RQT (slow preset, rd_candidates=3): the native split-TU trial and
    the Python oracle produce byte-identical bitstreams, and the split
    actually fires on high-detail content."""
    import hashlib

    from turingcodec.encode.encoder import (EncoderConfig,
                                                encode_yuv_stream)
    if native.get_lib() is None:
        pytest.skip("native core unavailable")
    rng2 = np.random.default_rng(23)
    w, h = 128, 64
    n_frames = 3
    base = rng2.integers(0, 256, (h, w), np.int32)
    base[8:40, 8:40] = rng2.integers(0, 256, (32, 32))
    frames = []
    for i in range(n_frames):
        y = np.clip(np.roll(base, (0, 3 * i), (0, 1))
                    + rng2.integers(-3, 4, (h, w)), 0, 255)
        u = np.clip(rng2.integers(100, 156, (h // 2, w // 2)), 0, 255)
        frames.append(y.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes())
    raw = b"".join(frames)
    cfg = EncoderConfig(width=w, height=h, qp=27, rd_candidates=3,
                        search_range=16)
    bs_nat, md5_nat = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    os.environ["TURING_NO_NATIVE_ENC"] = "1"
    try:
        bs_py, md5_py = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    finally:
        del os.environ["TURING_NO_NATIVE_ENC"]
    assert md5_nat == md5_py
    assert hashlib.md5(bs_nat).hexdigest() == hashlib.md5(bs_py).hexdigest()


def test_native_python_encoder_aps_bit_identical():
    """Medium preset (rd_candidates=2) with APS + ESD active: native and
    Python searchers stay byte-identical."""
    import hashlib

    from turingcodec.encode.encoder import (EncoderConfig,
                                                encode_yuv_stream)
    if native.get_lib() is None:
        pytest.skip("native core unavailable")
    rng2 = np.random.default_rng(31)
    w, h = 128, 64
    n_frames = 3
    base = rng2.integers(0, 256, (h, w), np.int32)
    base[:, :40] = (base[:, :40] // 16) * 16  # flat left, detailed right
    frames = []
    for i in range(n_frames):
        y = np.clip(np.roll(base, (2 * i, 5 * i), (0, 1))
                    + rng2.integers(-3, 4, (h, w)), 0, 255)
        u = np.clip(rng2.integers(100, 156, (h // 2, w // 2)), 0, 255)
        frames.append(y.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes())
    raw = b"".join(frames)
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=2,
                        search_range=16)
    bs_nat, md5_nat = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    os.environ["TURING_NO_NATIVE_ENC"] = "1"
    try:
        bs_py, md5_py = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    finally:
        del os.environ["TURING_NO_NATIVE_ENC"]
    assert md5_nat == md5_py
    assert hashlib.md5(bs_nat).hexdigest() == hashlib.md5(bs_py).hexdigest()


def test_native_python_encoder_bpic_seed_install_bit_identical():
    """Hierarchical-B at a MET preset with RDOQ: the noise-adapt path runs
    native dense_analysis for list-0's ref plane and installs it as an
    external seed field. On B pictures whose list-1 ref-0 is a DIFFERENT
    plane, the install is partial — the native prepass must compute the
    missing list's seeds in-picture (matching the lazily-per-plane Python
    twin) rather than dropping list-1's lowres ME candidate."""
    import hashlib

    from turingcodec.encode.encoder import (EncoderConfig,
                                                encode_yuv_stream)
    if native.get_lib() is None:
        pytest.skip("native core unavailable")
    rng2 = np.random.default_rng(47)
    w, h = 192, 128
    n_frames = 5  # gop_m=4: IDR + 1 full SOP (mid + leaf Bs)
    base = rng2.integers(0, 256, (2 * h, 2 * w), np.int32)
    frames = []
    for i in range(n_frames):
        # fast pan so the lowres/dense seed candidates matter for both
        # reference lists on the B pictures
        y = base[h // 2 + 12 * i:h // 2 + 12 * i + h,
                 w // 2 + 8 * i:w // 2 + 8 * i + w]
        u = np.full((h // 2, w // 2), 128)
        frames.append(y.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes()
                      + u.astype(np.uint8).tobytes())
    raw = b"".join(frames)
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=2,
                        search_range=32, met=True, rdoq=True, gop_m=4)
    bs_nat, md5_nat = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    os.environ["TURING_NO_NATIVE_ENC"] = "1"
    try:
        bs_py, md5_py = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    finally:
        del os.environ["TURING_NO_NATIVE_ENC"]
    assert md5_nat == md5_py
    assert hashlib.md5(bs_nat).hexdigest() == hashlib.md5(bs_py).hexdigest()


def test_native_python_encoder_intra64_bit_identical():
    """64x64 intra CUs (slow preset, forced TU split): native and Python
    searchers stay byte-identical, and the 64x64 trial actually wins
    somewhere (smooth gradients at high QP — the stream changes when the
    trial is disabled)."""
    import hashlib

    from turingcodec.encode.encoder import (EncoderConfig,
                                                encode_yuv_stream)
    if native.get_lib() is None:
        pytest.skip("native core unavailable")
    w, h = 192, 128
    n_frames = 3
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n_frames):
        # smooth diagonal gradient, slowly drifting: large intra CUs win
        y = ((xx + yy * 2 + i * 5) // 3 % 256).astype(np.uint8)
        u = np.full((h // 2, w // 2), 128, np.uint8)
        frames.append(y.tobytes() + u.tobytes() + u.tobytes())
    raw = b"".join(frames)
    cfg = EncoderConfig(width=w, height=h, qp=37, rd_candidates=3,
                        search_range=16, gop_m=4, rdoq=True, sdh=True)
    bs_nat, md5_nat = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    os.environ["TURING_NO_NATIVE_ENC"] = "1"
    try:
        bs_py, md5_py = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    finally:
        del os.environ["TURING_NO_NATIVE_ENC"]
    assert md5_nat == md5_py
    assert hashlib.md5(bs_nat).hexdigest() == hashlib.md5(bs_py).hexdigest()
    os.environ["TC_NO_I64"] = "1"
    try:
        bs_no, _ = encode_yuv_stream(raw, cfg, n_frames=n_frames)
    finally:
        del os.environ["TC_NO_I64"]
    assert bs_no != bs_nat, "64x64 intra trial never won"
