"""Device (XLA) deblock twin vs the numpy twin: bit-exact on real streams.

Hooks the decoder's deblock call to capture (plan, pre-deblock planes),
runs both implementations on copies, and compares — over frames of the
bundled caminandes stream (WPP hierarchical-B, inter + intra edges) and a
multi-slice encode (slice-boundary gating).
"""
import numpy as np
import pytest

import turingcodec.decode.picture_recon as picture_recon
from turingcodec.decode.deblock_vec import _deblock_dir_vec
from turingcodec.decode.decoder import Decoder
from turingcodec.ops.deblock import deblock_picture_device


def _numpy_deblock(plan, geom, ry, rcb, rcr):
    # the pure numpy path (deblock_picture_vec would hand off to native)
    for vertical in (True, False):
        _deblock_dir_vec(plan, geom, ry, rcb, rcr, vertical)


def _decode_comparing(stream: bytes, n_frames: int) -> int:
    checked = 0
    orig = picture_recon.deblock_picture

    def hooked(plan, geom, ry, rcb, rcr):
        nonlocal checked
        ry_d, rcb_d, rcr_d = ry.copy(), rcb.copy(), rcr.copy()
        _numpy_deblock(plan, geom, ry, rcb, rcr)
        deblock_picture_device(plan, geom, ry_d, rcb_d, rcr_d)
        np.testing.assert_array_equal(ry, ry_d)
        np.testing.assert_array_equal(rcb, rcb_d)
        np.testing.assert_array_equal(rcr, rcr_d)
        checked += 1

    picture_recon.deblock_picture = hooked
    try:
        dec = Decoder()
        for i, _f in enumerate(dec.decode_stream(stream)):
            if i + 1 >= n_frames:
                break
    finally:
        picture_recon.deblock_picture = orig
    return checked


def test_device_deblock_caminandes(caminandes_bytes):
    assert _decode_comparing(caminandes_bytes, 5) >= 4


def test_device_deblock_multislice():
    import pathlib
    p = pathlib.Path(__file__).parent / "streams" / "ms_indep3.hevc"
    if not p.exists():
        pytest.skip("multi-slice stream not bundled")
    assert _decode_comparing(p.read_bytes(), 3) >= 2
