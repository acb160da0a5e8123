"""SEI payload breadth (turing/sei/all.h parity): every payload type the
reference parses has a typed parser; unknown/extension ones are typed-raw
and skip-safe."""
import numpy as np

from turingcodec.bitstream.writer import BitWriter
from turingcodec.hevc import sei


def _pl(fn):
    bw = BitWriter()
    fn(bw)
    if bw.nbits:
        bw.u(0, 8 - bw.nbits)
    return bw.get_bytes()


def test_payload_type_coverage():
    # the reference's SyntaxSei.h table (prefix+suffix, minus reserved)
    ref_types = {0, 1, 2, 3, 4, 5, 6, 9, 15, 16, 17, 19, 22, 23, 45, 47,
                 128, 129, 130, 131, 132, 133, 134, 135, 136, 137, 138,
                 139, 140, 141, 142, 143, 144, 147, 160, 161, 162, 163,
                 164, 165, 166, 167, 168, 176, 177, 178, 179, 180}
    ours = set(sei._STRUCTURED_PARSERS) | {sei.SEI_DECODED_PICTURE_HASH}
    missing = ref_types - ours
    assert not missing, sorted(missing)


def test_simple_payload_parses():
    assert sei.parse_recovery_point(
        _pl(lambda b: (b.se(2), b.u(1, 1), b.u(0, 1)))) == {
        "recovery_poc_cnt": 2, "exact_match_flag": 1,
        "broken_link_flag": 0}
    assert sei.parse_content_light_level(b"\x03\xe8\x01\x90") == {
        "max_content_light_level": 1000,
        "max_pic_average_light_level": 400}
    ffi = sei.parse_frame_field_info(b"\x14")
    assert ffi["ffinfo_pic_struct"] == 1
    d = sei.parse_display_orientation(
        _pl(lambda b: (b.u(0, 1), b.u(1, 1), b.u(0, 1),
                       b.u(90, 16), b.u(1, 1))))
    assert d["hor_flip"] == 1 and d["anticlockwise_rotation"] == 90
    r = sei.parse_region_refresh_info(b"\x80")
    assert r["refreshed_region_flag"] == 1
    tc = sei.parse_time_code(_pl(lambda b: (
        b.u(1, 2), b.u(1, 1), b.u(0, 1), b.u(0, 5), b.u(1, 1), b.u(0, 1),
        b.u(0, 1), b.u(7, 9), b.u(30, 6), b.u(12, 6), b.u(1, 5),
        b.u(0, 5))))
    assert tc["clock_ts"][0]["n_frames"] == 7
    assert tc["clock_ts"][0]["hours_value"] == 1


def test_scalable_nesting_recurses():
    # nest a recovery_point inside a scalable_nesting payload
    inner = sei.SeiMessage(6, _pl(lambda b: (b.se(0), b.u(1, 1),
                                             b.u(0, 1))))
    bw = BitWriter()
    bw.u(0, 1)  # bitstream_subset
    bw.u(0, 1)  # nesting_op_flag
    bw.u(1, 1)  # all_layers
    while bw.nbits:
        bw.u(1 if bw.nbits == 8 else 0, 1)  # nesting alignment quirk
    body = bw.get_bytes()
    # append the nested sei_message bytes
    bw2 = BitWriter()
    bw2.u(inner.payload_type, 8)
    bw2.u(len(inner.payload), 8)
    bw2.write_bytes(inner.payload)
    nested = body + bw2.get_bytes()
    out = sei.parse_scalable_nesting(nested)
    assert out["nested"] and out["nested"][0].payload_type == 6
    inner_parsed = sei.parse_structured(out["nested"][0])
    assert inner_parsed["exact_match_flag"] == 1


def test_scalable_nesting_default_op_flag():
    # spec D.2.27: with default_op_flag=1 the op loop starts at i=1, so
    # nesting_num_ops_minus1=1 codes exactly ONE (u(3), ue) op pair.
    inner = sei.SeiMessage(6, _pl(lambda b: (b.se(0), b.u(1, 1),
                                             b.u(0, 1))))
    bw = BitWriter()
    bw.u(1, 1)   # bitstream_subset
    bw.u(1, 1)   # nesting_op_flag
    bw.u(1, 1)   # default_op_flag
    bw.ue(1)     # nesting_num_ops_minus1 = 1
    bw.u(3, 3)   # nesting_max_temporal_id_plus1[1]
    bw.ue(5)     # nesting_op_idx[1]
    while bw.nbits:
        bw.u(1 if bw.nbits == 8 else 0, 1)  # nesting alignment quirk
    body = bw.get_bytes()
    bw2 = BitWriter()
    bw2.u(inner.payload_type, 8)
    bw2.u(len(inner.payload), 8)
    bw2.write_bytes(inner.payload)
    out = sei.parse_scalable_nesting(body + bw2.get_bytes())
    assert out["default_op_flag"] == 1
    assert len(out["ops"]) == 1
    assert out["ops"][0]["nesting_max_temporal_id_plus1"] == 3
    assert out["ops"][0]["nesting_op_idx"] == 5
    # the nested message parses only if alignment after the single op is right
    assert out["nested"] and out["nested"][0].payload_type == 6


def test_unknown_and_extension_types_are_skip_safe():
    for t in (139, 142, 165, 177, 250):
        m = sei.SeiMessage(t, b"\x12\x34")
        r = sei.parse_structured(m)
        assert r is None or isinstance(r, dict)


def test_structured_never_raises_on_truncation():
    for t, fn in sei._STRUCTURED_PARSERS.items():
        for payload in (b"", b"\x01", b"\xff\x00", b"\x80" * 3):
            m = sei.SeiMessage(t, payload)
            r = sei.parse_structured(m)  # must not raise
            assert r is None or isinstance(r, dict)


def test_default_user_data_matches_the_corpus():
    """The encoder's user-data SEI (uuid + name) is the one the streams in
    tests/streams carry, so default encodes keep their bytes."""
    import hashlib
    import os
    from turingcodec.encode.encoder import (SEI_IDENTITY, Encoder,
                                            EncoderConfig)
    payload = (hashlib.md5(SEI_IDENTITY.encode()).digest()
               + SEI_IDENTITY.encode())
    enc = Encoder(EncoderConfig(width=64, height=64))
    frame = [np.full((64, 64), 128, np.int16),
             np.full((32, 32), 128, np.int16),
             np.full((32, 32), 128, np.int16)]
    nal, _recon = enc.encode_frame(frame)
    assert payload in enc.headers() + nal
    path = os.path.join(os.path.dirname(__file__), "streams", "vfy_hp.hevc")
    with open(path, "rb") as fh:
        assert payload in fh.read()
