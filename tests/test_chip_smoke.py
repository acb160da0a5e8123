"""chip_smoke.py: it refuses to run without a GPU, and its phases pass at
64x64 on the CPU backend (the same code paths at a tiny size)."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 64


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu_backend():
    r = _run_script(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "turingcodec" in r.stderr


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.fixture(scope="module")
def frames(smoke):
    return smoke.make_frames(W, H, 9, seed=1)


def test_content_is_seeded_420(smoke, frames):
    import numpy as np
    assert len(frames) == 9
    assert [p.shape for p in frames[0]] == [(H, W), (H // 2, W // 2),
                                            (H // 2, W // 2)]
    again = smoke.make_frames(W, H, 9, seed=1)
    assert all(np.array_equal(a, b) for fa, fb in zip(frames, again)
               for a, b in zip(fa, fb))
    assert not np.array_equal(frames[0][0], frames[1][0])


def test_phase1_kernels(smoke):
    smoke.phase1_kernels(64, iters=0)


def test_phase1_analysis(smoke, frames):
    from turingcodec.encode.encoder import Encoder, EncoderConfig
    zscan = Encoder(EncoderConfig(width=W, height=H)).geom.zscan
    smoke.phase1_analysis(frames[1][0], frames[0][0], zscan)


def test_phase1_loop_filters(smoke, frames):
    smoke.phase1_loop_filters(frames, W, H)


@pytest.mark.parametrize("cfg,n", [("LDP_FAST", 8), ("RA_SAO", 9)])
def test_phase2_encode_phase3_decode(smoke, frames, cfg, n):
    counter = smoke.CompileCounter()
    data = smoke.phase2_encode(cfg, frames[:n], W, H, getattr(smoke, cfg),
                               counter)
    smoke.phase3_decode(cfg, data, n, counter)


def test_phase3_golden(smoke):
    smoke.phase3_golden()


def test_trace_reduction(smoke, tmp_path):
    """device_times on a recorded CPU trace: one program, whose kernels
    are counted and whose busy time fits the window."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def scaled_sum(x):
        return (x * 3).sum()

    x = jnp.ones((256, 256))
    scaled_sum(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            scaled_sum(x).block_until_ready()
    per, busy, window, layout = smoke.device_times(str(tmp_path), "CPU")
    assert "jit_scaled_sum" in per and per["jit_scaled_sum"][0] >= 3
    assert 0 < busy <= window
    assert layout
