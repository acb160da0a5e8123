"""checkRate invariant (turing/Write.h:715-726,820-826): the search's
committed per-CTU rate — every mode bin and residual bin of the chosen
path, estimated with exact CABAC context states — must equal a writer
re-walk of the final plan integer-exactly (1/256-bit units).
"""
import os

import numpy as np
import pytest

from turingcodec.encode.encoder import EncoderConfig, Encoder
from turingcodec.encode.rate_check import writer_walk_frac


def _frames(n, w, h, seed=7):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h + 8, w + 8)).astype(np.int16)
    out = []
    for i in range(n):
        # shifted crops: temporally predictable content exercises
        # merge/skip/AMVP paths rather than degenerate all-intra choices
        y = base[i:i + h, i:i + w]
        out.append([np.ascontiguousarray(y),
                    np.ascontiguousarray(base[i:i + h // 2, i:i + w // 2]),
                    np.ascontiguousarray(base[i + 4:i + 4 + h // 2,
                                              i:i + w // 2])])
    return out


def _check(cfg, frames):
    enc = Encoder(cfg)
    out = [enc.headers()]
    per_pic = []
    for f in frames:
        for (_i, nal, _r) in enc.push_frame([p.copy() for p in f]):
            out.append(nal)
            per_pic.append((enc._last_plan, enc._last_sh,
                            enc._last_ctu_frac))
    for (_i, nal, _r) in enc.flush():
        out.append(nal)
        per_pic.append((enc._last_plan, enc._last_sh, enc._last_ctu_frac))
    assert per_pic, "no pictures encoded"
    for pi, (plan, sh, frac) in enumerate(per_pic):
        walk = writer_walk_frac(plan, enc.geom, sh)
        assert len(frac) == len(walk) != 0, (pi, len(frac), len(walk))
        for i, (a, b) in enumerate(zip(frac, walk)):
            assert a == b, (
                f"pic {pi} CTU {i}: search committed {a} frac-bits, "
                f"writer walk produced {b}")
    return b"".join(out)


@pytest.mark.parametrize("rdoq", [False, True])
def test_rate_invariant_intra(rdoq):
    cfg = EncoderConfig(width=96, height=64, qp=30, gop_m=1, intra_period=1,
                        sao=False, rdoq=rdoq, sdh=rdoq)
    _check(cfg, _frames(2, 96, 64))


def test_rate_invariant_inter_ldp():
    cfg = EncoderConfig(width=96, height=64, qp=32, gop_m=1, sao=False)
    _check(cfg, _frames(4, 96, 64))


def test_rate_invariant_inter_b_slow():
    cfg = EncoderConfig(width=96, height=64, qp=30, gop_m=4, sao=False,
                        rd_candidates=3, rdoq=True, sdh=True)
    _check(cfg, _frames(5, 96, 64))


@pytest.mark.parametrize("gop_m", [3, 6])
def test_rate_invariant_odd_gops(gop_m):
    # the non-power-of-two SOP tables (InputQueue.cpp:331-379) with their
    # per-level qp offsets also satisfy search rate == writer rate
    cfg = EncoderConfig(width=96, height=64, qp=33, gop_m=gop_m, sao=False,
                        rd_candidates=2, rdoq=True, sdh=True)
    _check(cfg, _frames(gop_m + 2, 96, 64))


def test_rate_invariant_python_oracle():
    # pure-Python twin obeys the same invariant
    os.environ["TURING_NO_NATIVE"] = "1"
    try:
        cfg = EncoderConfig(width=64, height=64, qp=34, gop_m=1, sao=False)
        _check(cfg, _frames(3, 64, 64))
    finally:
        os.environ.pop("TURING_NO_NATIVE", None)
