"""Device (XLA) inter reconstruction parity: the jitted per-picture MC +
batched residual pipeline must reproduce the host path bit-exactly (decode
md5 equality on inter streams). Runs on the CPU backend via conftest."""
import os

import numpy as np
import pytest


def _decode_md5(data, env=None, device=False):
    from turingcodec.decode.decoder import decode_to_yuv
    saved = {}
    env = env or {}
    for k, v in env.items():
        saved[k] = os.environ.get(k)
        os.environ[k] = v
    try:
        return decode_to_yuv(data, device=device)[0]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("stream", ["smp_g4.hevc", "vfy_sweep.hevc",
                                    "static_test.hevc", "amp_test.hevc"])
def test_device_inter_recon_matches_host(stream):
    path = os.path.join(os.path.dirname(__file__), "streams", stream)
    data = open(path, "rb").read()
    ref = _decode_md5(data)
    dev = _decode_md5(data, {"TURING_DEVICE_RECON": "1"})
    assert dev == ref


def test_mc_block_grid_matches_scalar():
    """ops/inter.mc_block_grid vs the scalar interp oracle on random MVs."""
    from turingcodec.decode.inter_pred import interp_chroma, interp_luma
    from turingcodec.ops.inter import mc_block_grid
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    h, w = 64, 96
    refs = rng.integers(0, 256, (2, h, w)).astype(np.int16)
    b = 64
    sel = rng.integers(0, 2, b).astype(np.int32)
    xi = rng.integers(-8, w + 4, b).astype(np.int32)
    yi = rng.integers(-8, h + 4, b).astype(np.int32)
    xf = rng.integers(0, 4, b).astype(np.int32)
    yf = rng.integers(0, 4, b).astype(np.int32)
    out = np.asarray(mc_block_grid(jnp.asarray(refs), jnp.asarray(sel),
                                   jnp.asarray(xi), jnp.asarray(yi),
                                   jnp.asarray(xf), jnp.asarray(yf),
                                   4, 8, 8))
    for i in range(b):
        want = interp_luma(refs[sel[i]], int(xi[i]), int(yi[i]),
                           int(xf[i]), int(yf[i]), 4, 4, 8)
        np.testing.assert_array_equal(out[i], want, err_msg=str(i))
    # chroma 4-tap
    xf8 = rng.integers(0, 8, b).astype(np.int32)
    yf8 = rng.integers(0, 8, b).astype(np.int32)
    out = np.asarray(mc_block_grid(jnp.asarray(refs), jnp.asarray(sel),
                                   jnp.asarray(xi), jnp.asarray(yi),
                                   jnp.asarray(xf8), jnp.asarray(yf8),
                                   2, 4, 8))
    for i in range(b):
        want = interp_chroma(refs[sel[i]], int(xi[i]), int(yi[i]),
                             int(xf8[i]), int(yf8[i]), 2, 2, 8)
        np.testing.assert_array_equal(out[i], want, err_msg=str(i))


@pytest.mark.parametrize("stream", ["smp_g4.hevc", "vfy_sweep.hevc",
                                    "static_test.hevc", "amp_test.hevc"])
def test_device_pipeline_matches_host(stream):
    """Chained device pipeline (decode/device_pipeline.py): MC -> residual
    -> (host intra) -> deblock -> SAO with one pull per picture and the
    device-resident DPB must reproduce the host decode bit-exactly."""
    path = os.path.join(os.path.dirname(__file__), "streams", stream)
    data = open(path, "rb").read()
    ref = _decode_md5(data)
    dev = _decode_md5(data, device=True)
    assert dev == ref


@pytest.mark.parametrize("stream,host", [
    ("vfy_sweep.hevc", {}),
    ("vfy_wp.hevc", {"weighted prediction": 3}),
])
def test_device_pipeline_counts_host_pictures_by_reason(stream, host):
    """The pipeline has no weighted prediction: those pictures go to the
    host and are counted under that reason; other pictures stay on it."""
    from turingcodec.decode.decoder import Decoder
    path = os.path.join(os.path.dirname(__file__), "streams", stream)
    dec = Decoder(device=True)
    for _ in dec.decode_stream(open(path, "rb").read()):
        pass
    assert dec.hash_failures == 0
    assert dict(dec.device_fallbacks) == host
    off = Decoder(device=False)
    for _ in off.decode_stream(open(path, "rb").read()):
        pass
    assert dict(off.device_fallbacks) == {}
