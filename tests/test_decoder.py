"""Decoder correctness oracle (SURVEY.md §4.1 analogue): bit-exact decode of
the bundled caminandes stream vs the reference decoder's output.

Golden md5 05c8e88dd7a694829f34ad9486a0dd8e was produced by the reference
`turing decode` (built from /root/reference) over all 120 frames.
"""
import hashlib

import numpy as np
import pytest

from turingcodec.decode.decoder import Decoder

GOLDEN_FULL_MD5 = "05c8e88dd7a694829f34ad9486a0dd8e"
# per-frame first-GOP md5s (frames 0..8 in output order), derived from the
# same golden YUV
GOLDEN_FRAME0_MD5 = None  # computed lazily if reference yuv present


def _frame_bytes(frame):
    return np.concatenate(
        [p.astype(np.uint8).ravel() for p in frame.planes]).tobytes()


def test_decode_first_gop(caminandes_bytes):
    """First 9 output frames decode and hash deterministically."""
    dec = Decoder()
    md5 = hashlib.md5()
    n = 0
    for f in dec.decode_stream(caminandes_bytes, max_frames=9):
        assert f.poc == n
        md5.update(_frame_bytes(f))
        n += 1
    assert n == 9
    # golden: md5 of the reference decoder's first 9 output frames
    assert md5.hexdigest() == "5ced2518dc5fa31c9fc7454ca7316443"


@pytest.mark.slow
def test_decode_full_stream(caminandes_bytes):
    dec = Decoder()
    md5 = hashlib.md5()
    n = 0
    for f in dec.decode_stream(caminandes_bytes):
        md5.update(_frame_bytes(f))
        n += 1
    assert n == 120
    assert md5.hexdigest() == GOLDEN_FULL_MD5
