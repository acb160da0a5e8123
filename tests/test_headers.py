"""Header parse + re-serialize oracle (SURVEY.md §7 stage 1)."""
import pytest

from turingcodec.bitstream.reader import BitReader, iter_nal_units
from turingcodec.bitstream.writer import BitWriter
from turingcodec.hevc import types as T
from turingcodec.hevc.header_syntax import (
    parse_pps,
    parse_slice_segment_header,
    parse_sps,
    parse_vps,
    write_pps,
    write_slice_segment_header,
    write_sps,
)
from turingcodec.hevc.params import ParamSets


@pytest.fixture(scope="module")
def parsed(caminandes_bytes):
    ps = ParamSets()
    slices = []
    nal_payloads = {}
    for nal in iter_nal_units(caminandes_bytes):
        br = BitReader(nal.rbsp)
        if nal.nal_unit_type == T.NalUnitType.VPS_NUT:
            v = parse_vps(br)
            ps.vps[v.vps_video_parameter_set_id] = v
        elif nal.nal_unit_type == T.NalUnitType.SPS_NUT:
            s = parse_sps(br)
            ps.sps[s.sps_seq_parameter_set_id] = s
            nal_payloads["sps"] = nal.rbsp
        elif nal.nal_unit_type == T.NalUnitType.PPS_NUT:
            p = parse_pps(br)
            ps.pps[p.pps_pic_parameter_set_id] = p
            nal_payloads["pps"] = nal.rbsp
        elif T.is_vcl(nal.nal_unit_type):
            sh = parse_slice_segment_header(
                br, nal.nal_unit_type, nal.temporal_id, ps)
            slices.append((sh, br.pos, nal.rbsp))
    return ps, slices, nal_payloads


def test_sps_fields(parsed):
    ps, _, _ = parsed
    sps = ps.sps[0]
    assert sps.pic_width_in_luma_samples == 640
    assert sps.pic_height_in_luma_samples == 360
    assert sps.ctb_size_y == 64
    assert sps.pic_width_in_ctbs_y == 10
    assert sps.pic_height_in_ctbs_y == 6
    assert sps.bit_depth_y == 8


def test_slice_headers(parsed):
    ps, slices, _ = parsed
    assert len(slices) == 120
    sh0 = slices[0][0]
    assert sh0.slice_type == 2  # I
    assert sh0.num_entry_point_offsets == 5  # 6 WPP rows
    # hierarchical GOP8: poc pattern
    pocs = [s[0].slice_pic_order_cnt_lsb for s in slices[:9]]
    assert pocs == [0, 8, 4, 2, 1, 3, 6, 5, 7]


def test_slice_header_reserialize(parsed):
    """Every slice header must re-serialize bit-exactly (stage-1 oracle)."""
    ps, slices, _ = parsed
    for sh, end_pos, rbsp in slices:
        sps, pps = ps.activate(sh.slice_pic_parameter_set_id)
        bw = BitWriter()
        write_slice_segment_header(bw, sh, sps, pps)
        got = bw.get_bytes()
        want = rbsp[: end_pos // 8]
        assert end_pos % 8 == 0
        assert got == want, (
            f"slice header mismatch poc={sh.slice_pic_order_cnt_lsb}")


def test_sps_pps_reserialize(parsed):
    """SPS/PPS writers reproduce the parsed stream bit-exactly.

    (The caminandes SPS has no VUI and default scaling lists, so the writer's
    fixed choices — no VUI, no explicit scaling lists — are exercised.)
    """
    ps, _, payloads = parsed
    bw = BitWriter()
    write_sps(bw, ps.sps[0])
    assert bw.get_bytes() == payloads["sps"]
    bw = BitWriter()
    write_pps(bw, ps.pps[0])
    assert bw.get_bytes() == payloads["pps"]


def test_level_derivation():
    """general_level_idc from the A.4 levels table (Encoder.cpp:590-606):
    smallest Main-tier level fitting picture size and luma sample rate."""
    from turingcodec.hevc.tables import derive_level
    assert derive_level(352 * 288, 30.0)[0] == 60       # CIF30 -> 2.0
    assert derive_level(640 * 360, 24.0)[0] == 63       # 360p24 -> 2.1
    assert derive_level(1920 * 1080, 24.0)[0] == 120    # 1080p24 -> 4.0
    assert derive_level(1920 * 1080, 60.0)[0] == 123    # 1080p60 -> 4.1
    assert derive_level(3840 * 2160, 60.0)[0] == 153    # 2160p60 -> 5.1
    # the encoder signals it in the SPS PTL
    from turingcodec.encode.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(width=640, height=360, qp=30,
                                frame_rate=24.0))
    assert enc.sps.ptl.general_level_idc == 63
