"""Main10 (10-bit) encode/decode round trip."""
import numpy as np

from turingcodec.decode.decoder import Decoder
from turingcodec.encode.encoder import Encoder, EncoderConfig


def test_10bit_roundtrip():
    rng = np.random.default_rng(0)
    w, h = 64, 64
    yy, xx = np.mgrid[0:h, 0:w]
    y = (512 + 256 * np.sin(xx / 17.0)).clip(0, 1023).astype(np.int16)
    cb = np.full((h // 2, w // 2), 512, np.int16)
    cr = (512 + 128 * np.cos(yy[::2, ::2] / 19.0)).clip(0, 1023).astype(np.int16)
    cfg = EncoderConfig(width=w, height=h, qp=30, rd_candidates=1,
                        bit_depth=10, gop_m=1, search_range=8)
    enc = Encoder(cfg)
    stream = enc.headers()
    recons = []
    for i in range(2):
        f = [np.roll(p, i, axis=1) for p in (y, cb, cr)]
        _, nal, recon = enc.push_frame(f)[0]
        stream += nal
        recons.append(recon)
    frames = list(Decoder().decode_stream(stream))
    for f, r in zip(frames, recons):
        assert f.hash_ok
        for a, b in zip(f.planes, r):
            np.testing.assert_array_equal(a, b)
    mse = ((frames[0].planes[0].astype(float) - y.astype(float)) ** 2).mean()
    assert 10 * np.log10(1023 ** 2 / max(mse, 1e-9)) > 40
