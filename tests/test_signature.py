"""Golden-hash regression (turing signature analogue): any drift in
encoder decisions fails here first; determinism rows must match the
default row byte-for-byte."""


def test_signature_matrix():
    from turingcodec.tools.signature import run
    assert run() == 0
