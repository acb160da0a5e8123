"""The native core's cache key: sources, flags and host CPU."""
import os
import shutil

from turingcodec import native

HERE = os.path.dirname(native.__file__)


def _copy_sources(dst):
    for name in native._SOURCES + native._HEADERS:
        shutil.copy(os.path.join(HERE, name), dst)


def test_key_covers_sources_flags_and_cpu(tmp_path):
    _copy_sources(tmp_path)
    flags = native._flags()
    base = native._so_path(str(tmp_path), flags, b"cpu-a")
    assert os.path.dirname(base) == str(tmp_path)
    assert native._so_path(str(tmp_path), flags, b"cpu-a") == base
    assert native._so_path(str(tmp_path), flags, b"cpu-b") != base
    assert native._so_path(str(tmp_path), flags + ["-DX"], b"cpu-a") != base
    with open(tmp_path / "core.h", "ab") as fh:
        fh.write(b"\n")
    assert native._so_path(str(tmp_path), flags, b"cpu-a") != base


def test_library_of_another_key_is_never_loaded(tmp_path):
    """Only the .so under this host's key loads: libraries planted under
    another CPU's key and under the old unkeyed name are left alone."""
    lib = native.get_lib()
    assert lib is not None
    flags, cpu = native._flags(), native._cpu_identity()
    assert native.so_path == native._so_path(HERE, flags, cpu)

    _copy_sources(tmp_path)
    mine = native._so_path(str(tmp_path), flags, cpu)
    shutil.copy(native.so_path, mine)
    planted = [native._so_path(str(tmp_path), flags, b"another cpu"),
               str(tmp_path / "_cabac_core_cpython-312.so")]
    for p in planted:
        with open(p, "wb") as fh:
            fh.write(b"not a shared library")
    saved = native.build_seconds, native.so_path
    try:
        native.build_seconds = 0.0
        other = native._build_and_load(str(tmp_path))
        assert other is not None
        assert native.so_path == mine
        assert native.build_seconds == 0.0   # loaded, not rebuilt
    finally:
        native.build_seconds, native.so_path = saved
    for p in planted:
        with open(p, "rb") as fh:
            assert fh.read() == b"not a shared library"
