"""Device encoder analysis (EncoderConfig.device): the jitted pre-ME
seed fields must equal the host twins exactly, and a full encode with the
device stage on must produce a byte-identical bitstream."""
import os

import numpy as np
import pytest

from turingcodec.encode.encoder import EncoderConfig, Encoder


def _frames(n, w, h, seed=11):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h + 16, w + 16)).astype(np.int16)
    out = []
    for i in range(n):
        out.append([np.ascontiguousarray(base[i:i + h, i * 2:i * 2 + w]),
                    np.ascontiguousarray(base[:h // 2, :w // 2]),
                    np.ascontiguousarray(base[8:8 + h // 2, :w // 2])])
    return out


def test_seed_field_matches_host_oracle():
    from turingcodec.encode.device_analysis import seed_field_device
    from turingcodec.encode.inter_search import InterPictureEncoder
    rng = np.random.RandomState(3)
    h, w = 96, 144   # non-multiples of 64 exercise the clamped decimation
    orig = rng.randint(0, 256, (h, w)).astype(np.int16)
    ref = np.roll(orig, (3, -5), (0, 1)).astype(np.int16)
    ref[40:60, 40:80] = rng.randint(0, 256, (20, 40))

    dev, wb_d, hb_d = seed_field_device(orig, ref)

    # host oracle via the Python encoder's private helper
    enc = InterPictureEncoder.__new__(InterPictureEncoder)
    enc._lr_seed_cache = {}
    enc.orig = [orig]
    host, wb_h, hb_h = enc._lowres_seed_field(ref)
    assert (wb_d, hb_d) == (wb_h, hb_h)
    assert np.array_equal(dev, host), (
        np.argwhere(~(dev == host).all(-1))[:5])


def test_dense_field_matches_host_oracle():
    from turingcodec.encode.device_analysis import analysis_device
    from turingcodec.encode.inter_search import InterPictureEncoder
    rng = np.random.RandomState(5)
    h, w = 112, 176   # non-multiples of 64 exercise the padding
    orig = rng.randint(0, 256, (h, w)).astype(np.int16)
    ref = np.roll(orig, (-7, 9), (0, 1)).astype(np.int16)
    ref[30:70, 50:120] = rng.randint(0, 256, (40, 70))

    sm_d, dm_d, ds_d, wb_d, hb_d = analysis_device(orig, ref)

    enc = InterPictureEncoder.__new__(InterPictureEncoder)
    enc._lr_seed_cache = {}
    enc._dense_cache = {}
    enc.orig = [orig]
    dm_h, ds_h, wb_h, hb_h = enc._dense_field(ref)
    sm_h = enc._lr_seed_cache[id(ref)][0]
    assert (wb_d, hb_d) == (wb_h, hb_h)
    assert np.array_equal(sm_d, sm_h)
    assert np.array_equal(dm_d, dm_h), (
        np.argwhere(~(dm_d == dm_h).all(-1))[:5])
    assert np.array_equal(ds_d, ds_h)

    # the native standalone analysis must agree too
    from turingcodec import native
    res = native.dense_analysis(orig, ref, 8)
    if res is not None:
        sm_n, dm_n, ds_n, wb_n, hb_n = res[:5]
        assert (wb_n, hb_n) == (wb_h, hb_h)
        assert np.array_equal(sm_n, sm_h)
        assert np.array_equal(dm_n, dm_h)
        assert np.array_equal(ds_n, ds_h)
        # full SAD surface: device twin == native (the exact integers
        # the full-pel search serves aligned probes from)
        surf_n = res[5]
        if surf_n is not None:
            from turingcodec.encode.device_analysis import (
                analysis_device)
            out = analysis_device(orig, ref, want_surf=True)
            assert np.array_equal(out[5], surf_n)
            assert np.array_equal(out[1], dm_h)  # argmin tie-break parity


def _encode(frames, w, h, env, device=False):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = EncoderConfig(width=w, height=h, qp=32, gop_m=4, sao=False,
                            rdoq=True, sdh=True, rd_candidates=2,
                            device=device)
        enc = Encoder(cfg)
        out = [enc.headers()]
        for f in frames:
            for (_i, nal, _r) in enc.push_frame([p.copy() for p in f]):
                out.append(nal)
        for (_i, nal, _r) in enc.flush():
            out.append(nal)
        return b"".join(out)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_device_enc_bitstream_identical():
    frames = _frames(5, 128, 96)
    ref = _encode(frames, 128, 96, {})
    dev = _encode(frames, 128, 96, {}, device=True)
    assert dev == ref


def test_device_enc_bitstream_identical_python_twin():
    frames = _frames(4, 96, 64)
    ref = _encode(frames, 96, 64, {"TURING_NO_NATIVE": "1"})
    dev = _encode(frames, 96, 64, {"TURING_NO_NATIVE": "1"}, device=True)
    assert dev == ref


def test_subpel_planes_match_mc_oracle():
    """The XLA subpel-plane twin must reproduce mc_interp semantics
    (per-sample coordinate clamping, >>shift1 / >>6 integer arithmetic)
    for every fractional position, including the padded border."""
    from turingcodec.encode.device_analysis import (SP_P,
                                                        subpel_planes_device)
    from turingcodec.hevc.tables import LUMA_FILTER
    rng = np.random.RandomState(7)
    h, w = 22, 37
    for bd in (8, 10):
        ref = rng.randint(0, 1 << bd, (h, w)).astype(np.int16)
        got = subpel_planes_device(ref, bd)
        assert got.shape == (15, h + 2 * SP_P, w + 2 * SP_P)
        shift1 = bd - 8

        def refpx(y, x):
            return int(ref[min(max(y, 0), h - 1), min(max(x, 0), w - 1)])

        def hval(y, x, xf):
            f = LUMA_FILTER[xf]
            acc = sum(int(f[k]) * refpx(y, x - 3 + k) for k in range(8))
            return acc >> shift1

        for yf in range(4):
            for xf in range(4):
                if xf == 0 and yf == 0:
                    continue
                pos = xf + 4 * yf
                pl = got[pos - 1]
                # spot-check a grid incl. the pad corners
                for py in (0, 1, SP_P, SP_P + 5, h + 2 * SP_P - 1):
                    for px in (0, 1, SP_P, SP_P + 11, w + 2 * SP_P - 1):
                        y, x = py - SP_P, px - SP_P
                        if yf == 0:
                            exp = hval(y, x, xf)
                        elif xf == 0:
                            f = LUMA_FILTER[yf]
                            exp = sum(int(f[k]) * refpx(y - 3 + k, x)
                                      for k in range(8)) >> shift1
                        else:
                            f = LUMA_FILTER[yf]
                            exp = sum(int(f[k]) * hval(y - 3 + k, x, xf)
                                      for k in range(8)) >> 6
                        exp = np.int16(exp)
                        assert pl[py, px] == exp, (bd, xf, yf, py, px)


def _mk_ctx(w, h):
    from turingcodec.decode.plan import PicturePlan
    from turingcodec.decode.reconstruct import ReferenceSampleBuilder
    from turingcodec.hevc.geometry import PictureGeometry
    cfg = EncoderConfig(width=w, height=h, qp=32, rd_candidates=2)
    enc = Encoder(cfg)
    plan = PicturePlan(enc.sps, enc.pps)
    geom = enc.geom
    refs = ReferenceSampleBuilder(plan, geom)
    return enc, plan, geom, refs


def test_rank_satd_tables_match_inloop_oracle():
    """The batched source-referenced rank-SATD tables must equal the
    in-loop ranking's integers (refs.build + _mode_satds) at every
    sampled aligned position and size."""
    from turingcodec.encode.device_analysis import rank_satd_tables_host
    from turingcodec.encode.intra_search import IntraPictureEncoder
    rng = np.random.RandomState(9)
    w, h = 192, 128
    plane = rng.randint(0, 256, (h, w)).astype(np.int16)
    plane[40:80, 60:140] = (np.add.outer(np.arange(40), np.arange(80)) * 2
                            % 256)
    enc, plan, geom, refs = _mk_ctx(w, h)
    strong = bool(enc.sps.strong_intra_smoothing_enabled_flag)
    tabs = rank_satd_tables_host(plane, geom.zscan, 8, strong)

    probe = IntraPictureEncoder.__new__(IntraPictureEncoder)
    probe.sps = enc.sps
    probe.bd = 8
    probe.refs = refs
    probe.rd_candidates = 2
    for n in (4, 8, 16, 32):
        hn, wn = h // n, w // n
        assert tabs[n].shape == (hn, wn, 35)
        # sample positions incl. borders
        for by, bx in [(0, 0), (0, wn - 1), (hn - 1, 0),
                       (hn // 2, wn // 2), (hn - 1, wn - 1)]:
            x0, y0 = bx * n, by * n
            rt, rl, co = refs.build(plane, x0, y0, n, 0, 8)
            ob = plane[y0:y0 + n, x0:x0 + n].astype(np.int32)
            exp = probe._mode_satds(ob, rt, rl, co, n)
            got = tabs[n][by, bx]
            assert np.array_equal(got, np.asarray(exp).astype(np.int32)), \
                (n, by, bx)


def test_rank_satd_tables_device_matches_host():
    """XLA rank-SATD tables must be integer-exact vs the numpy twin."""
    from turingcodec.encode.device_analysis import (
        rank_satd_tables_device, rank_satd_tables_host)
    rng = np.random.RandomState(5)
    w, h = 128, 96
    plane = rng.randint(0, 256, (h, w)).astype(np.int16)
    plane[20:60, 30:100] = (np.add.outer(np.arange(40), np.arange(70))
                            % 256)
    _enc, _plan, geom, _refs = _mk_ctx(w, h)
    hostt = rank_satd_tables_host(plane, geom.zscan, 8, True)
    devt = rank_satd_tables_device(plane, geom.zscan, 8, True)
    for n in (4, 8, 16, 32):
        assert np.array_equal(hostt[n], devt[n]), n
