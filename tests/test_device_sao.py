"""Device (XLA) SAO twin vs the numpy reference: bit-exact on real streams.

Hooks the decoder's SAO call to compare both implementations per picture.
vfy_sweep.hevc is the bundled GOP8+SAO stream (cross-validated against the
reference decoder in GOLDEN.json); an encoder round-trip adds band/edge
variety at a different QP.
"""
import pathlib

import numpy as np
import pytest

import turingcodec.decode.picture_recon as picture_recon
from turingcodec.decode.decoder import Decoder
from turingcodec.ops.sao import sao_picture_device

_STREAMS = pathlib.Path(__file__).parent / "streams"


def _decode_comparing(stream: bytes, n_frames: int) -> int:
    checked = 0
    orig = picture_recon.sao_picture

    def hooked(plan, geom, planes):
        nonlocal checked
        ref = orig(plan, geom, [p.copy() for p in planes])
        dev = sao_picture_device(plan, geom, planes)
        for a, b in zip(ref, dev):
            np.testing.assert_array_equal(a, b)
        checked += 1
        return ref

    picture_recon.sao_picture = hooked
    try:
        dec = Decoder()
        for i, _f in enumerate(dec.decode_stream(stream)):
            if i + 1 >= n_frames:
                break
    finally:
        picture_recon.sao_picture = orig
    return checked


def test_device_sao_gop8_stream():
    p = _STREAMS / "vfy_sweep.hevc"
    if not p.exists():
        pytest.skip("SAO stream not bundled")
    assert _decode_comparing(p.read_bytes(), 6) >= 4


def test_device_sao_encoder_roundtrip():
    from turingcodec.encode.encoder import Encoder, EncoderConfig
    rng = np.random.default_rng(3)
    w, h = 192, 128
    cfg = EncoderConfig(width=w, height=h, qp=34, rd_candidates=1,
                        search_range=16, sao=True)
    enc = Encoder(cfg)
    stream = enc.headers()
    yy, xx = np.mgrid[0:h, 0:w]
    base = [(128 + 60 * np.sin(xx / 9.0) + rng.normal(0, 8, (h, w)))
            .clip(0, 255).astype(np.int16),
            (128 + 40 * np.cos(xx[::2, ::2] / 7.0)).clip(0, 255)
            .astype(np.int16),
            (128 + 40 * np.sin(yy[::2, ::2] / 5.0)).clip(0, 255)
            .astype(np.int16)]
    for i in range(3):
        f = [np.roll(p, 2 * i, axis=1) for p in base]
        nal, _recon = enc.encode_frame(f)
        stream += nal
    assert _decode_comparing(stream, 3) >= 2
