import numpy as np
import pytest

from turingcodec.bitstream.reader import (
    BitReader,
    insert_emulation_prevention,
    iter_nal_units,
    remove_emulation_prevention,
)
from turingcodec.bitstream.writer import BitWriter


def test_ep3_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(50):
        raw = bytes(rng.integers(0, 4, size=rng.integers(1, 200)).astype(np.uint8))
        ebsp = insert_emulation_prevention(raw)
        assert remove_emulation_prevention(ebsp) == raw
        # EBSP must contain no 00 00 0[0-2] sequence (00 00 03 is the escape)
        for i in range(len(ebsp) - 2):
            if ebsp[i] == 0 and ebsp[i + 1] == 0:
                assert ebsp[i + 2] >= 3


def test_ep3_specific():
    assert remove_emulation_prevention(b"\x00\x00\x03\x00") == b"\x00\x00\x00"
    assert remove_emulation_prevention(b"\x00\x00\x03\x01") == b"\x00\x00\x01"
    assert insert_emulation_prevention(b"\x00\x00\x00\x00") == b"\x00\x00\x03\x00\x00"
    assert insert_emulation_prevention(b"\x00\x00\x03") == b"\x00\x00\x03\x03"


def test_bitreader_ue_se():
    bw = BitWriter()
    values = [0, 1, 2, 3, 4, 5, 100, 65535]
    for v in values:
        bw.ue(v)
    svalues = [0, 1, -1, 2, -2, 17, -100]
    for v in svalues:
        bw.se(v)
    bw.rbsp_trailing_bits()
    br = BitReader(bw.get_bytes())
    assert [br.ue() for _ in values] == values
    assert [br.se() for _ in svalues] == svalues


def test_bitreader_u():
    bw = BitWriter()
    bw.u(0x5, 3)
    bw.u(0x1234, 16)
    bw.u(1, 1)
    bw.u(0, 4)  # pad to byte
    br = BitReader(bw.get_bytes())
    assert br.u(3) == 5
    assert br.u(16) == 0x1234
    assert br.u(1) == 1


def test_nal_iteration(caminandes_bytes):
    nals = list(iter_nal_units(caminandes_bytes))
    assert len(nals) == 123  # VPS+SPS+PPS+120 slices
    assert nals[0].type_name == "VPS_NUT"
    assert nals[1].type_name == "SPS_NUT"
    assert nals[2].type_name == "PPS_NUT"
    assert nals[3].type_name == "IDR_N_LP"


def test_more_rbsp_data():
    br = BitReader(b"\x80")  # just a stop bit
    assert not br.more_rbsp_data()
    br = BitReader(b"\xc0")  # one data bit + stop bit
    assert br.more_rbsp_data()
    assert br.u(1) == 1
    assert not br.more_rbsp_data()
