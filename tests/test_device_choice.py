"""The entry points' device argument and the compile-cache helper."""
import os

import jax
import pytest

from turingcodec.utils.device import (DEFAULT_CACHE_DIR, REPO_ROOT,
                                      device_stages_on, enable_compile_cache)


def test_none_resolves_off_on_the_cpu_backend():
    from turingcodec.decode.decoder import Decoder
    from turingcodec.encode.encoder import Encoder, EncoderConfig
    assert jax.default_backend() == "cpu"
    assert device_stages_on(None) is False
    assert Encoder(EncoderConfig(width=64, height=64)).device is False
    assert Decoder().device is False


@pytest.mark.parametrize("choice", [True, False])
def test_explicit_choice_is_kept(choice):
    from turingcodec.decode.decoder import Decoder
    from turingcodec.encode.encoder import Encoder, EncoderConfig
    assert device_stages_on(choice) is choice
    assert Encoder(EncoderConfig(width=64, height=64,
                                 device=choice)).device is choice
    assert Decoder(device=choice).device is choice


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = enable_compile_cache()
        assert got == str(DEFAULT_CACHE_DIR) == os.path.join(
            str(REPO_ROOT), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert enable_compile_cache() == got   # no per-run path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(REPO_ROOT / ".gitignore") as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("env,unknown", [
    ({"TURING_NO_NATIVE": "1", "TURING_FRAME_THREADS": "2"}, []),
    ({"TURING_NO_NATIVE": "1", "TURING_NO_NATIVEE": "1", "PATH": "/"},
     ["TURING_NO_NATIVEE"]),
])
def test_unknown_switches_are_reported(env, unknown):
    import warnings
    import turingcodec
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert turingcodec.warn_unknown_switches(env) == unknown
    assert len(caught) == len(unknown[:1])
    if unknown:
        assert unknown[0] in str(caught[0].message)


def test_every_switch_read_is_known():
    import re
    import turingcodec
    read = set()
    for path in list((REPO_ROOT / "turingcodec").rglob("*.py")) + [
            REPO_ROOT / "bench.py", REPO_ROOT / "__graft_entry__.py"]:
        read |= set(re.findall(r"[\"'](TURING_[A-Z_]+)[\"']",
                               path.read_text()))
    assert read and read <= turingcodec.SWITCHES
