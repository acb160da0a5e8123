"""Parity tests for batched prediction device twins."""
import numpy as np
import pytest

from turingcodec.ops.intra import (
    intra_predict_all_modes,
    intra_predict_all_modes_np,
)
from turingcodec.ops.inter import (
    interp_luma_all_phases,
    interp_luma_all_phases_np,
)

rng = np.random.default_rng(11)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_intra_all_modes_parity(n):
    b = 4
    rt = rng.integers(0, 256, (b, 2 * n + 1)).astype(np.int32)
    rl = rng.integers(0, 256, (b, 2 * n + 1)).astype(np.int32)
    co = rng.integers(0, 256, b).astype(np.int32)
    got = np.asarray(intra_predict_all_modes(rt, rl, co, n))
    want = intra_predict_all_modes_np(rt, rl, co, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wh", [(8, 8), (16, 8)])
def test_interp_all_phases_parity(wh):
    w, h = wh
    b = 2
    win = rng.integers(0, 256, (b, h + 7, w + 7)).astype(np.int16)
    got = np.asarray(interp_luma_all_phases(win, w, h)).astype(np.int64)
    want = interp_luma_all_phases_np(win, w, h)
    np.testing.assert_array_equal(got, want)
