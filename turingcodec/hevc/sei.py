"""SEI message framework (spec 7.3.5 / Annex D).

Parity reference: turing/SyntaxSei.h (payload dispatch), turing/sei/
decoded_picture_hash.h, TaskEncodeOutput.cpp:105-209 (encoder-side SEI).
Implemented payloads: decoded_picture_hash (md5/crc/checksum),
user_data_unregistered; unknown payloads are preserved as raw bytes.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from turingcodec.bitstream.reader import BitReader
from turingcodec.bitstream.writer import BitWriter, wrap_nal
from turingcodec.hevc import types as T

SEI_DECODED_PICTURE_HASH = 132
SEI_USER_DATA_UNREGISTERED = 5
SEI_ACTIVE_PARAMETER_SETS = 129
SEI_PIC_TIMING = 1
SEI_BUFFERING_PERIOD = 0


@dataclass
class SeiMessage:
    payload_type: int
    payload: bytes


def parse_sei_rbsp(rbsp: bytes) -> List[SeiMessage]:
    """sei_rbsp(): one or more sei_message()."""
    out = []
    br = BitReader(rbsp)
    while br.bits_left() > 8:
        ptype = 0
        while True:
            b = br.u(8)
            ptype += b
            if b != 0xFF:
                break
        psize = 0
        while True:
            b = br.u(8)
            psize += b
            if b != 0xFF:
                break
        payload = bytes(br.u(8) for _ in range(psize))
        out.append(SeiMessage(ptype, payload))
        if not br.more_rbsp_data():
            break
    return out


def write_sei_nal(messages: List[SeiMessage], suffix: bool = False,
                  temporal_id: int = 0) -> bytes:
    bw = BitWriter()
    for m in messages:
        t = m.payload_type
        while t >= 255:
            bw.u(0xFF, 8)
            t -= 255
        bw.u(t, 8)
        s = len(m.payload)
        while s >= 255:
            bw.u(0xFF, 8)
            s -= 255
        bw.u(s, 8)
        bw.write_bytes(m.payload)
    bw.rbsp_trailing_bits()
    nut = (T.NalUnitType.SUFFIX_SEI_NUT if suffix
           else T.NalUnitType.PREFIX_SEI_NUT)
    return wrap_nal(nut, bw.get_bytes(), temporal_id=temporal_id)


# ---------------------------------------------------------------- hashes

def _plane_bytes(plane: np.ndarray, bit_depth: int) -> bytes:
    if bit_depth <= 8:
        return plane.astype(np.uint8).tobytes()
    return plane.astype("<u2").tobytes()


def picture_md5(planes, bit_depth: int = 8) -> List[bytes]:
    return [hashlib.md5(_plane_bytes(p, bit_depth)).digest() for p in planes]


_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tab = np.zeros(256, np.uint32)
        for b in range(256):
            crc = b << 8
            for _ in range(8):
                crc = ((crc << 1) ^ (0x1021 if crc & 0x8000 else 0)) & 0xFFFF
            tab[b] = crc
        _CRC_TABLE = tab
    return _CRC_TABLE


def picture_crc(planes, bit_depth: int = 8) -> List[int]:
    """Annex D.3.19 CRC-16 (x^16+x^12+x^5+1, init 0xFFFF).

    The spec feeds data bits into the LSB while reducing at the MSB, then
    shifts 16 trailing zero bits; per byte that is
    crc' = tab[crc >> 8] ^ ((crc & 0xFF) << 8) ^ byte.
    """
    tab = _crc_table()
    out = []
    for p in planes:
        data = np.frombuffer(_plane_bytes(p, bit_depth) + b"\x00\x00",
                             np.uint8)
        crc = 0xFFFF
        for byte in data.tolist():
            crc = (int(tab[crc >> 8]) ^ ((crc & 0xFF) << 8) ^ byte) & 0xFFFF
        out.append(crc)
    return out


def picture_checksum(planes, bit_depth: int = 8) -> List[int]:
    """Annex D.3.19 checksum (vectorized)."""
    out = []
    for p in planes:
        h, w = p.shape
        yy, xx = np.mgrid[0:h, 0:w]
        xor_mask = ((xx & 0xFF) ^ (yy & 0xFF) ^ (xx >> 8) ^ (yy >> 8)
                    ).astype(np.uint32)
        vals = p.astype(np.uint32)
        s = int(((vals & 0xFF) ^ xor_mask).sum(dtype=np.uint64))
        if bit_depth > 8:
            s += int((((vals >> 8) & 0xFF) ^ xor_mask).sum(dtype=np.uint64))
        out.append(s & 0xFFFFFFFF)
    return out


def make_decoded_picture_hash(planes, hash_type: int = 0,
                              bit_depth: int = 8) -> SeiMessage:
    bw = bytearray([hash_type])
    if hash_type == 0:
        for d in picture_md5(planes, bit_depth):
            bw.extend(d)
    elif hash_type == 1:
        for c in picture_crc(planes, bit_depth):
            bw.extend(c.to_bytes(2, "big"))
    else:
        for c in picture_checksum(planes, bit_depth):
            bw.extend(c.to_bytes(4, "big"))
    return SeiMessage(SEI_DECODED_PICTURE_HASH, bytes(bw))


def verify_decoded_picture_hash(msg: SeiMessage, planes,
                                bit_depth: int = 8) -> bool:
    want = make_decoded_picture_hash(planes, msg.payload[0], bit_depth)
    return want.payload == msg.payload


# ------------------------------------------------- structured payloads
# The payload set the reference encoder actively writes
# (TaskEncodeOutput.cpp:105-209): active_parameter_sets, pic_timing,
# user_data_unregistered, mastering_display_colour_volume,
# alternative_transfer_characteristics (+ decoded_picture_hash above).

SEI_MASTERING_DISPLAY = 137
SEI_ALTERNATIVE_TRANSFER = 147


def _finish_payload(bw: BitWriter) -> bytes:
    """SEI payload trailing bits (D.1): align with a 1 then 0s."""
    if bw.nbits:
        bw.u(1, 1)
        if bw.nbits:
            bw.u(0, 8 - bw.nbits)
    return bw.get_bytes()


def make_active_parameter_sets(vps_id: int = 0, sps_id: int = 0,
                               self_contained: int = 0,
                               no_update: int = 0) -> SeiMessage:
    """active_parameter_sets (D.2.21 / sei/active_parameter_sets.h)."""
    bw = BitWriter()
    bw.u(vps_id, 4)
    bw.u(self_contained, 1)
    bw.u(no_update, 1)
    bw.ue(0)  # num_sps_ids_minus1
    bw.ue(sps_id)
    return SeiMessage(SEI_ACTIVE_PARAMETER_SETS, _finish_payload(bw))


def parse_active_parameter_sets(payload: bytes) -> dict:
    br = BitReader(payload)
    return {"vps_id": br.u(4), "self_contained_cvs_flag": br.u(1),
            "no_parameter_set_update_flag": br.u(1),
            "sps_ids": [br.ue() for _ in range(br.ue() + 1)]}


def make_pic_timing(pic_struct=None, source_scan_type: int = 1,
                    duplicate_flag: int = 0, *,
                    au_cpb_removal_delay_minus1=None,
                    pic_dpb_output_delay: int = 0,
                    au_len: int = 24, dpb_len: int = 24) -> SeiMessage:
    """pic_timing (D.2.3 / D.3.3).

    The frame_field_info section (pic_struct/scan/duplicate) is written
    when pic_struct is not None (requires VUI frame_field_info=1); the
    CPB/DPB delay section when au_cpb_removal_delay_minus1 is not None
    (requires VUI HRD with nal/vcl hrd params — CpbDpbDelaysPresentFlag).
    au_len/dpb_len are (au_cpb_removal_delay_length_minus1 + 1) and
    (dpb_output_delay_length_minus1 + 1) from the active hrd_parameters.
    The reference emits only the frame_field part (sei/pic_timing.h);
    HRD timing is beyond-reference."""
    bw = BitWriter()
    if pic_struct is not None:
        bw.u(pic_struct, 4)
        bw.u(source_scan_type, 2)
        bw.u(duplicate_flag, 1)
    if au_cpb_removal_delay_minus1 is not None:
        bw.u(au_cpb_removal_delay_minus1, au_len)
        bw.u(pic_dpb_output_delay, dpb_len)
    return SeiMessage(SEI_PIC_TIMING, _finish_payload(bw))


def parse_pic_timing(payload: bytes, frame_field: bool = True,
                     cpb_dpb_delays: bool = False, au_len: int = 24,
                     dpb_len: int = 24) -> dict:
    br = BitReader(payload)
    out = {}
    if frame_field:
        out.update(pic_struct=br.u(4), source_scan_type=br.u(2),
                   duplicate_flag=br.u(1))
    if cpb_dpb_delays:
        out.update(au_cpb_removal_delay_minus1=br.u(au_len),
                   pic_dpb_output_delay=br.u(dpb_len))
    return out


def make_buffering_period(sps_id: int = 0, *,
                          nal_initial_cpb_removal_delay,
                          nal_initial_cpb_removal_offset,
                          concatenation_flag: int = 0,
                          au_cpb_removal_delay_delta_minus1: int = 0,
                          init_len: int = 24, au_len: int = 24
                          ) -> SeiMessage:
    """buffering_period (D.2.2 / D.3.2), NAL HRD single-sub-layer form
    (sub_pic_hrd off, irap_cpb_params off). The delay/offset lists carry
    one entry per CPB (CpbCnt); values in 90 kHz clock ticks. init_len is
    (initial_cpb_removal_delay_length_minus1 + 1). Beyond-reference: the
    reference encoder emits no buffering_period SEI."""
    bw = BitWriter()
    bw.ue(sps_id)
    bw.u(0, 1)  # irap_cpb_params_present_flag
    bw.u(concatenation_flag, 1)
    bw.u(au_cpb_removal_delay_delta_minus1, au_len)
    for d, o in zip(nal_initial_cpb_removal_delay,
                    nal_initial_cpb_removal_offset):
        bw.u(d, init_len)
        bw.u(o, init_len)
    return SeiMessage(SEI_BUFFERING_PERIOD, _finish_payload(bw))


def parse_buffering_period(payload: bytes, cpb_cnt: int = 1,
                           init_len: int = 24, au_len: int = 24) -> dict:
    br = BitReader(payload)
    out = {"bp_seq_parameter_set_id": br.ue(),
           "irap_cpb_params_present_flag": br.u(1)}
    if out["irap_cpb_params_present_flag"]:
        out["cpb_delay_offset"] = br.u(au_len)
        out["dpb_delay_offset"] = br.u(24)
    out["concatenation_flag"] = br.u(1)
    out["au_cpb_removal_delay_delta_minus1"] = br.u(au_len)
    out["nal_initial_cpb_removal_delay"] = []
    out["nal_initial_cpb_removal_offset"] = []
    for _ in range(cpb_cnt):
        out["nal_initial_cpb_removal_delay"].append(br.u(init_len))
        out["nal_initial_cpb_removal_offset"].append(br.u(init_len))
    return out


def make_user_data_unregistered(uuid: bytes, data: bytes) -> SeiMessage:
    """user_data_unregistered (D.2.7): 16-byte UUID + payload bytes."""
    assert len(uuid) == 16
    return SeiMessage(SEI_USER_DATA_UNREGISTERED, uuid + data)


def parse_user_data_unregistered(payload: bytes) -> dict:
    return {"uuid": payload[:16], "data": payload[16:]}


def make_mastering_display(primaries, white_point, max_luminance: int,
                           min_luminance: int) -> SeiMessage:
    """mastering_display_colour_volume (D.2.28): primaries/white point in
    0.00002 units, luminance in 0.0001 cd/m2 units."""
    bw = BitWriter()
    for (x, y) in primaries:
        bw.u(x, 16)
        bw.u(y, 16)
    bw.u(white_point[0], 16)
    bw.u(white_point[1], 16)
    bw.u(max_luminance, 32)
    bw.u(min_luminance, 32)
    return SeiMessage(SEI_MASTERING_DISPLAY, _finish_payload(bw))


def parse_mastering_display(payload: bytes) -> dict:
    br = BitReader(payload)
    prim = [(br.u(16), br.u(16)) for _ in range(3)]
    return {"primaries": prim, "white_point": (br.u(16), br.u(16)),
            "max_luminance": br.u(32), "min_luminance": br.u(32)}


def make_alternative_transfer_characteristics(tc: int) -> SeiMessage:
    """alternative_transfer_characteristics (D.2.38)."""
    bw = BitWriter()
    bw.u(tc, 8)
    return SeiMessage(SEI_ALTERNATIVE_TRANSFER, _finish_payload(bw))


def parse_alternative_transfer_characteristics(payload: bytes) -> dict:
    return {"preferred_transfer_characteristics": payload[0]}


# --- breadth: the reference's full prefix/suffix payload set -----------
# (turing/sei/all.h, SyntaxSei.h:39-87). Each type below gets a typed
# parse; layered/multiview extension payloads (160+) and the handful of
# tool-specific hint messages keep their fields raw but typed, like the
# reference's blacklist-and-skip handling for profiles it doesn't decode.

def parse_pan_scan_rect(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"pan_scan_rect_id": br.ue(),
           "pan_scan_rect_cancel_flag": br.u(1)}
    if not out["pan_scan_rect_cancel_flag"]:
        n = br.ue() + 1
        out["rects"] = [dict(left=br.se(), right=br.se(),
                             top=br.se(), bottom=br.se())
                        for _ in range(n)]
        out["pan_scan_rect_persistence_flag"] = br.u(1)
    return out


def parse_user_data_registered_t35(payload: bytes) -> dict:
    i = 1
    cc = payload[0]
    if cc == 0xFF:
        cc = (cc << 8) | payload[1]
        i = 2
    return {"itu_t_t35_country_code": cc, "payload": payload[i:]}


def parse_recovery_point(payload: bytes) -> dict:
    br = BitReader(payload)
    return {"recovery_poc_cnt": br.se(),
            "exact_match_flag": br.u(1),
            "broken_link_flag": br.u(1)}


def parse_scene_info(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"scene_info_present_flag": br.u(1)}
    if out["scene_info_present_flag"]:
        out["prev_scene_id_valid_flag"] = br.u(1)
        out["scene_id"] = br.ue()
        out["scene_transition_type"] = br.ue()
        if out["scene_transition_type"] > 3:
            out["second_scene_id"] = br.ue()
    return out


def parse_picture_snapshot(payload: bytes) -> dict:
    return {"snapshot_id": BitReader(payload).ue()}


def parse_progressive_refinement_start(payload: bytes) -> dict:
    br = BitReader(payload)
    return {"progressive_refinement_id": br.ue(),
            "pic_order_cnt_delta": br.ue()}


def parse_progressive_refinement_end(payload: bytes) -> dict:
    return {"progressive_refinement_id": BitReader(payload).ue()}


def parse_film_grain_characteristics(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"film_grain_characteristics_cancel_flag": br.u(1)}
    if out["film_grain_characteristics_cancel_flag"]:
        return out
    out["film_grain_model_id"] = br.u(2)
    out["separate_colour_description_present_flag"] = br.u(1)
    if out["separate_colour_description_present_flag"]:
        out["film_grain_bit_depth_luma_minus8"] = br.u(3)
        out["film_grain_bit_depth_chroma_minus8"] = br.u(3)
        out["film_grain_full_range_flag"] = br.u(1)
        out["film_grain_colour_primaries"] = br.u(8)
        out["film_grain_transfer_characteristics"] = br.u(8)
        out["film_grain_matrix_coeffs"] = br.u(8)
    out["blending_mode_id"] = br.u(2)
    out["log2_scale_factor"] = br.u(4)
    comps = []
    flags = [br.u(1) for _ in range(3)]
    for c in range(3):
        if not flags[c]:
            comps.append(None)
            continue
        comp = {"num_intensity_intervals_minus1": br.u(8),
                "num_model_values_minus1": br.u(3), "intervals": []}
        for _ in range(comp["num_intensity_intervals_minus1"] + 1):
            iv = {"lower": br.u(8), "upper": br.u(8),
                  "values": [br.se()
                             for _ in range(comp["num_model_values_minus1"]
                                            + 1)]}
            comp["intervals"].append(iv)
        comps.append(comp)
    out["components"] = comps
    out["film_grain_characteristics_persistence_flag"] = br.u(1)
    return out


def parse_post_filter_hint(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"filter_hint_size_y": br.ue(), "filter_hint_size_x": br.ue(),
           "filter_hint_type": br.u(2)}
    n = out["filter_hint_size_y"] * out["filter_hint_size_x"]
    if n <= 4096:
        out["filter_hint"] = [[br.se() for _ in range(n)]
                              for _ in range(3)]
    return out


def parse_tone_mapping_info(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"tone_map_id": br.ue(), "tone_map_cancel_flag": br.u(1)}
    if out["tone_map_cancel_flag"]:
        return out
    out["tone_map_persistence_flag"] = br.u(1)
    out["coded_data_bit_depth"] = br.u(8)
    out["target_bit_depth"] = br.u(8)
    model = out["tone_map_model_id"] = br.ue()
    if model == 0:
        out["min_value"] = br.u(32)
        out["max_value"] = br.u(32)
    elif model == 1:
        out["sigmoid_midpoint"] = br.u(32)
        out["sigmoid_width"] = br.u(32)
    elif model == 3:
        n = br.u(16)
        cb = (out["coded_data_bit_depth"] + 7) >> 3
        tb = (out["target_bit_depth"] + 7) >> 3
        out["pivots"] = [(br.u(8 * cb), br.u(8 * tb)) for _ in range(n)]
    elif model == 4:
        out["camera_iso_speed_idc"] = br.u(8)
        if out["camera_iso_speed_idc"] == 255:
            out["camera_iso_speed_value"] = br.u(32)
        out["exposure_index_idc"] = br.u(8)
        if out["exposure_index_idc"] == 255:
            out["exposure_index_value"] = br.u(32)
        out["exposure_compensation_value_sign_flag"] = br.u(1)
        out["exposure_compensation_value_numerator"] = br.u(16)
        out["exposure_compensation_value_denom_idc"] = br.u(16)
        out["ref_screen_luminance_white"] = br.u(32)
        out["extended_range_white_level"] = br.u(32)
        out["nominal_black_level_code_value"] = br.u(16)
        out["nominal_white_level_code_value"] = br.u(16)
        out["extended_white_level_code_value"] = br.u(16)
    return out


def parse_frame_packing_arrangement(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"frame_packing_arrangement_id": br.ue(),
           "frame_packing_arrangement_cancel_flag": br.u(1)}
    if out["frame_packing_arrangement_cancel_flag"]:
        return out
    out["frame_packing_arrangement_type"] = br.u(7)
    out["quincunx_sampling_flag"] = br.u(1)
    out["content_interpretation_type"] = br.u(6)
    out["spatial_flipping_flag"] = br.u(1)
    out["frame0_flipped_flag"] = br.u(1)
    out["field_views_flag"] = br.u(1)
    out["current_frame_is_frame0_flag"] = br.u(1)
    out["frame0_self_contained_flag"] = br.u(1)
    out["frame1_self_contained_flag"] = br.u(1)
    if not out["quincunx_sampling_flag"] \
            and out["frame_packing_arrangement_type"] != 5:
        for k in ("frame0_grid_position_x", "frame0_grid_position_y",
                  "frame1_grid_position_x", "frame1_grid_position_y"):
            out[k] = br.u(4)
    out["frame_packing_arrangement_reserved_byte"] = br.u(8)
    out["frame_packing_arrangement_persistence_flag"] = br.u(1)
    out["upsampled_aspect_ratio_flag"] = br.u(1)
    return out


def parse_display_orientation(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"display_orientation_cancel_flag": br.u(1)}
    if not out["display_orientation_cancel_flag"]:
        out["hor_flip"] = br.u(1)
        out["ver_flip"] = br.u(1)
        out["anticlockwise_rotation"] = br.u(16)
        out["display_orientation_persistence_flag"] = br.u(1)
    return out


def parse_structure_of_pictures_info(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"sop_seq_parameter_set_id": br.ue(), "entries": []}
    n = br.ue() + 1
    for i in range(n):
        e = {"sop_vcl_nut": br.u(6), "sop_temporal_id": br.u(3)}
        if e["sop_vcl_nut"] not in (T.NalUnitType.IDR_W_RADL,
                                    T.NalUnitType.IDR_N_LP):
            e["sop_short_term_rps_idx"] = br.ue()
        if i > 0:
            e["sop_poc_delta"] = br.se()
        out["entries"].append(e)
    return out


def parse_decoding_unit_info(payload: bytes) -> dict:
    return {"decoding_unit_idx": BitReader(payload).ue(),
            "raw": payload}  # CPB-delay fields need the active HRD


def parse_temporal_sub_layer_zero_index(payload: bytes) -> dict:
    br = BitReader(payload)
    return {"temporal_sub_layer_zero_idx": br.u(8),
            "irap_pic_id": br.u(8)}


def parse_scalable_nesting(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"bitstream_subset_flag": br.u(1),
           "nesting_op_flag": br.u(1)}
    if out["nesting_op_flag"]:
        out["default_op_flag"] = br.u(1)
        out["nesting_num_ops_minus1"] = br.ue()
        ops = []
        # spec D.2.27 / ref sei/scalable_nesting.h:37-41: the op loop starts
        # at i = default_op_flag (when the default op applies, entry 0 is
        # implicit and not coded)
        for _ in range(out["default_op_flag"],
                       out["nesting_num_ops_minus1"] + 1):
            ops.append({"nesting_max_temporal_id_plus1": br.u(3),
                        "nesting_op_idx": br.ue()})
        out["ops"] = ops
    else:
        out["all_layers_flag"] = br.u(1)
        if not out["all_layers_flag"]:
            out["nesting_no_op_max_temporal_id_plus1"] = br.u(3)
            out["nesting_num_layers_minus1"] = br.ue()
            out["nesting_layer_id"] = [
                br.u(6) for _ in range(out["nesting_num_layers_minus1"] + 1)]
    while br.pos % 8:
        br.u(1)  # nesting_zero_bit alignment
    # the nested messages themselves
    rest = payload[br.pos // 8:]
    out["nested"] = parse_sei_rbsp(rest + b"\x80")
    return out


def parse_region_refresh_info(payload: bytes) -> dict:
    return {"refreshed_region_flag": BitReader(payload).u(1)}


def parse_no_display(payload: bytes) -> dict:
    return {}


def parse_time_code(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"num_clock_ts": br.u(2), "clock_ts": []}
    for _ in range(out["num_clock_ts"]):
        ts = {"clock_timestamp_flag": br.u(1)}
        if ts["clock_timestamp_flag"]:
            ts["units_field_based_flag"] = br.u(1)
            ts["counting_type"] = br.u(5)
            ts["full_timestamp_flag"] = br.u(1)
            ts["discontinuity_flag"] = br.u(1)
            ts["cnt_dropped_flag"] = br.u(1)
            ts["n_frames"] = br.u(9)
            if ts["full_timestamp_flag"]:
                ts["seconds_value"] = br.u(6)
                ts["minutes_value"] = br.u(6)
                ts["hours_value"] = br.u(5)
            else:
                if br.u(1):  # seconds_flag
                    ts["seconds_value"] = br.u(6)
                    if br.u(1):  # minutes_flag
                        ts["minutes_value"] = br.u(6)
                        if br.u(1):  # hours_flag
                            ts["hours_value"] = br.u(5)
            n = br.u(5)
            if n:
                ts["time_offset_value"] = br.u(n)
        out["clock_ts"].append(ts)
    return out


def parse_segmented_rect_fpa(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"segmented_rect_frame_packing_arrangement_cancel_flag": br.u(1)}
    if not out["segmented_rect_frame_packing_arrangement_cancel_flag"]:
        out["segmented_rect_content_interpretation_type"] = br.u(2)
        out["segmented_rect_frame_packing_arrangement_persistence_flag"] \
            = br.u(1)
    return out


def parse_knee_function_info(payload: bytes) -> dict:
    br = BitReader(payload)
    out = {"knee_function_id": br.ue(),
           "knee_function_cancel_flag": br.u(1)}
    if out["knee_function_cancel_flag"]:
        return out
    out["knee_function_persistence_flag"] = br.u(1)
    out["input_d_range"] = br.u(32)
    out["input_disp_luminance"] = br.u(32)
    out["output_d_range"] = br.u(32)
    out["output_disp_luminance"] = br.u(32)
    n = br.ue() + 1
    out["knee_points"] = [(br.u(10), br.u(10)) for _ in range(n)]
    return out


def parse_content_light_level(payload: bytes) -> dict:
    br = BitReader(payload)
    return {"max_content_light_level": br.u(16),
            "max_pic_average_light_level": br.u(16)}


def parse_deinterlaced_field_identification(payload: bytes) -> dict:
    br = BitReader(payload)
    return {"deinterlaced_picture_source_parity_flag": br.u(1)}


def parse_temporal_mv_prediction_constraints(payload: bytes) -> dict:
    br = BitReader(payload)
    return {"prev_pics_not_used_flag": br.u(1),
            "no_intra_layer_col_pic_flag": br.u(1)}


def parse_frame_field_info(payload: bytes) -> dict:
    br = BitReader(payload)
    return {"ffinfo_pic_struct": br.u(4),
            "ffinfo_source_scan_type": br.u(2),
            "ffinfo_duplicate_flag": br.u(1)}


def _raw_typed(name):
    def parse(payload: bytes) -> dict:
        return {"payload_name": name, "raw": payload}
    return parse


_STRUCTURED_PARSERS = {
    0: parse_buffering_period,
    SEI_PIC_TIMING: parse_pic_timing,
    2: parse_pan_scan_rect,
    3: _raw_typed("filler_payload"),
    4: parse_user_data_registered_t35,
    SEI_USER_DATA_UNREGISTERED: parse_user_data_unregistered,
    6: parse_recovery_point,
    9: parse_scene_info,
    15: parse_picture_snapshot,
    16: parse_progressive_refinement_start,
    17: parse_progressive_refinement_end,
    19: parse_film_grain_characteristics,
    22: parse_post_filter_hint,
    23: parse_tone_mapping_info,
    45: parse_frame_packing_arrangement,
    47: parse_display_orientation,
    128: parse_structure_of_pictures_info,
    SEI_ACTIVE_PARAMETER_SETS: parse_active_parameter_sets,
    130: parse_decoding_unit_info,
    131: parse_temporal_sub_layer_zero_index,
    133: parse_scalable_nesting,
    134: parse_region_refresh_info,
    135: parse_no_display,
    136: parse_time_code,
    SEI_MASTERING_DISPLAY: parse_mastering_display,
    138: parse_segmented_rect_fpa,
    139: _raw_typed("temporal_motion_constrained_tile_sets"),
    140: _raw_typed("chroma_resampling_filter_hint"),
    141: parse_knee_function_info,
    142: _raw_typed("colour_remapping_info"),
    143: parse_deinterlaced_field_identification,
    144: parse_content_light_level,
    SEI_ALTERNATIVE_TRANSFER: parse_alternative_transfer_characteristics,
    # layered / multiview extension payloads: typed raw (the reference
    # reads them only structurally too)
    160: _raw_typed("layers_not_present"),
    161: _raw_typed("inter_layer_constrained_tile_sets"),
    162: _raw_typed("bsp_nesting"),
    163: _raw_typed("bsp_initial_arrival_time"),
    164: _raw_typed("sub_bitstream_property"),
    165: _raw_typed("alpha_channel_info"),
    166: _raw_typed("overlay_info"),
    167: parse_temporal_mv_prediction_constraints,
    168: parse_frame_field_info,
    176: _raw_typed("three_dimensional_reference_displays_info"),
    177: _raw_typed("depth_representation_info"),
    178: _raw_typed("multiview_scene_info"),
    179: _raw_typed("multiview_acquisition_info"),
    180: _raw_typed("multiview_view_position"),
}


def parse_structured(msg: SeiMessage):
    """Structured view of a known payload, or None."""
    fn = _STRUCTURED_PARSERS.get(msg.payload_type)
    try:
        return fn(msg.payload) if fn else None
    except (EOFError, IndexError):
        return None
