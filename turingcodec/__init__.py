"""turingcodec — an HEVC (H.265) video encoder/decoder in JAX and C++.

A from-scratch re-design of the capabilities of the BBC's Turing codec
(bbc/turingcodec) for a host plus an accelerator:

- Entropy (CABAC) and bitstream layers run on the host (Python/C++),
  producing/consuming *decision tensors* — the batched analogue of the
  reference's CodedData decision stream (reference turing/CodedData.h:37).
- The whole-picture pixel work (encoder ME analysis, MC, transforms,
  quantization, deblocking, SAO, SAD/SATD/SSD metrics) has batched JAX/XLA
  twins over picture tensors (reference havoc/ kernel library
  equivalent), integer-exact with the host code.
- Parallelism is expressed as jax.sharding over device meshes: wavefront
  rows become diagonal batches, concurrent frames become GOP shards
  (reference ThreadPool/TaskEncode* equivalents, SURVEY.md §2.7).
"""

import os as _os

# OpenBLAS worker threads spin-wait after every numpy call and steal a core
# from the native codec loops on small hosts; the codec does its own
# threading (OpenMP / wavefront rows), so pin BLAS to one thread unless the
# user overrides. Must happen before numpy first loads the BLAS library.
for _v in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
           "NUMEXPR_NUM_THREADS"):
    _os.environ.setdefault(_v, "1")

__version__ = "0.1.0"

# The environment switches the package reads. Any other TURING_* variable
# is a misspelt or retired name that would otherwise be ignored unseen.
SWITCHES = frozenset({
    "TURING_DEVICE_DEBLOCK", "TURING_DEVICE_RECON", "TURING_DEVICE_SAO",
    "TURING_ENC_THREADS", "TURING_FRAME_OVERLAP", "TURING_FRAME_THREADS",
    "TURING_NATIVE_PROF", "TURING_NO_NATIVE", "TURING_NO_NATIVE_ENC",
    "TURING_NO_NATIVE_PARSE", "TURING_NO_NATIVE_RECON",
    "TURING_NO_NATIVE_WRITE", "TURING_PIPELINE_TRACE",
})


def warn_unknown_switches(environ=_os.environ):
    """Warn about TURING_* variables the package does not read; returns
    their names."""
    unknown = sorted(k for k in environ
                     if k.startswith("TURING_") and k not in SWITCHES)
    if unknown:
        import warnings
        warnings.warn(f"turingcodec ignores {', '.join(unknown)}; its "
                      f"switches are {', '.join(sorted(SWITCHES))}",
                      stacklevel=2)
    return unknown


warn_unknown_switches()
