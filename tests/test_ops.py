"""Device-twin parity tests: JAX ops must match the numpy decoder oracle
bit-exactly (the analogue of `turing havoc` self-tests, havoc/havoc_test.h)."""
import numpy as np
import pytest

from turingcodec.decode.reconstruct import (
    dequant_block,
    inverse_transform,
)
from turingcodec.ops.metrics import sad_batch, satd_batch, satd_np, ssd_batch
from turingcodec.ops.quant import dequant_batch, dequant_np
from turingcodec.ops.transform import (
    forward_transform_batch,
    forward_transform_np,
    inverse_transform_batch,
)

rng = np.random.default_rng(7)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("bit_depth", [8, 10])
def test_inverse_transform_parity(log2, bit_depth):
    n = 1 << log2
    batch = rng.integers(-300, 300, size=(16, n, n)).astype(np.int32)
    got = np.asarray(inverse_transform_batch(batch, bit_depth, False))
    for i in range(batch.shape[0]):
        want = inverse_transform(batch[i], bit_depth, False)
        np.testing.assert_array_equal(got[i], want)


def test_inverse_dst_parity():
    batch = rng.integers(-300, 300, size=(16, 4, 4)).astype(np.int32)
    got = np.asarray(inverse_transform_batch(batch, 8, True))
    for i in range(batch.shape[0]):
        want = inverse_transform(batch[i], 8, True)
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_forward_inverse_roundtrip(log2):
    """Forward then inverse at QP 0-ish scale recovers residual closely, and
    the batched forward matches the numpy oracle exactly."""
    n = 1 << log2
    res = rng.integers(-255, 256, size=(8, n, n)).astype(np.int32)
    got = np.asarray(forward_transform_batch(res, 8, False))
    for i in range(res.shape[0]):
        want = forward_transform_np(res[i], 8, False)
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("log2", [2, 4])
@pytest.mark.parametrize("qp", [0, 17, 26, 37, 51])
def test_dequant_parity(log2, qp):
    n = 1 << log2
    lv = rng.integers(-3000, 3000, size=(12, n, n)).astype(np.int32)
    qps = np.full(12, qp, np.int32)
    got = np.asarray(dequant_batch(lv, qps, 8, log2))
    for i in range(12):
        want = dequant_np(lv[i], qp, 8, log2)
        np.testing.assert_array_equal(got[i], want)
        # also vs the decoder-side oracle (flat matrix)
        want2 = dequant_block(lv[i], qp, 8, log2)
        np.testing.assert_array_equal(got[i], want2)


def test_metrics_parity():
    a = rng.integers(0, 256, size=(5, 16, 16)).astype(np.int32)
    b = rng.integers(0, 256, size=(5, 16, 16)).astype(np.int32)
    sad = np.asarray(sad_batch(a, b))
    ssd = np.asarray(ssd_batch(a, b))
    satd = np.asarray(satd_batch(a, b, 8))
    for i in range(5):
        assert sad[i] == np.abs(a[i] - b[i]).sum()
        assert ssd[i] == ((a[i] - b[i]) ** 2).sum()
        assert satd[i] == satd_np(a[i], b[i], 8)


def test_satd4_parity():
    a = rng.integers(0, 256, size=(3, 8, 8)).astype(np.int32)
    b = rng.integers(0, 256, size=(3, 8, 8)).astype(np.int32)
    satd = np.asarray(satd_batch(a, b, 4))
    for i in range(3):
        assert satd[i] == satd_np(a[i], b[i], 4)
