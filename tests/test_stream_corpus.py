"""Regression corpus: every feature stream encoded during round 1, with
decoded-YUV goldens that the reference `turing` decoder reproduced
bit-exactly at the time of creation (tests/streams/GOLDEN.json)."""
import hashlib
import json
import os

import pytest

STREAMS_DIR = os.path.join(os.path.dirname(__file__), "streams")
GOLDEN = json.load(open(os.path.join(STREAMS_DIR, "GOLDEN.json")))
NAMES = [k for k in GOLDEN if not k.startswith("_")]


@pytest.mark.parametrize("name", NAMES)
def test_corpus_stream(name):
    from turingcodec.decode.decoder import Decoder

    data = open(os.path.join(STREAMS_DIR, name), "rb").read()
    dec = Decoder()
    md5 = hashlib.md5()
    n = 0
    for f in dec.decode_stream(data):
        assert f.hash_ok is not False, f"{name}: hash SEI mismatch"
        for p in f.planes:
            md5.update(p.astype("uint8").tobytes())
        n += 1
    assert n > 0 and not dec.violations, (name, dec.violations)
    assert md5.hexdigest() == GOLDEN[name], name
