"""Batched encoder-sweep helpers vs their scalar oracles."""
import numpy as np
import pytest

from turingcodec.encode.sweep import intra_all_modes_np, satd_many, sad_many
from turingcodec.decode.reconstruct import intra_predict
from turingcodec.ops.metrics import satd_np

rng = np.random.default_rng(11)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_intra_all_modes_matches_scalar(n):
    rt = rng.integers(0, 256, 2 * n + 1).astype(np.int32)
    rl = rng.integers(0, 256, 2 * n + 1).astype(np.int32)
    co = int(rng.integers(0, 256))
    preds = intra_all_modes_np(rt, rl, co, n)
    for mode in range(35):
        want = intra_predict(mode, rt, rl, co, n, 1, 8)  # c_idx=1: no edge filt
        np.testing.assert_array_equal(preds[mode], want, err_msg=f"mode {mode}")


@pytest.mark.parametrize("n,block", [(8, 8), (16, 8), (32, 8), (4, 4), (8, 4)])
def test_satd_many(n, block):
    orig = rng.integers(0, 256, (n, n)).astype(np.int32)
    preds = rng.integers(0, 256, (7, n, n)).astype(np.int32)
    got = satd_many(orig, preds, block)
    for i in range(7):
        assert got[i] == satd_np(orig, preds[i], block)


def test_sad_many():
    ref = rng.integers(0, 256, (64, 96)).astype(np.int32)
    orig = rng.integers(0, 256, (16, 16)).astype(np.int32)
    xs = np.array([-4, 0, 30, 70, 85])
    ys = np.array([0, -8, 20, 50, 52])
    got = sad_many(orig, ref, xs, ys, 16, 16)
    for i in range(5):
        ry = np.clip(np.arange(ys[i], ys[i] + 16), 0, 63)
        rx = np.clip(np.arange(xs[i], xs[i] + 16), 0, 95)
        want = np.abs(orig - ref[np.ix_(ry, rx)].astype(np.int64)).sum()
        assert got[i] == want
