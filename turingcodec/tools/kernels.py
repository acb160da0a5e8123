"""CLI: DSP kernel self-test + throughput benchmark on the current JAX
device (the `turing havoc` analogue, havoc/havoc.cpp:161-211): every kernel
family runs at the given batch and is checked bit-exact against its numpy
oracle, then timed.

The transform, quant, dequant, SAD and SSD oracles check every block; the
slower scalar oracles (SATD, intra, interp) check `--oracle-blocks`
blocks spread evenly over the batch.

Usage: python -m turingcodec.tools.kernels [--batch N] [--iters N]
           [--oracle-blocks N]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _bench(fn, args, iters):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    if iters <= 0:
        return float("nan")
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def check_kernels(batch=512, iters=20, oracle_blocks=64, seed=0):
    """Run each ops/ kernel at `batch` blocks; returns rows
    (name, ok, seconds per call, work items per call, unit)."""
    import jax.numpy as jnp

    from turingcodec.decode.reconstruct import inverse_transform
    from turingcodec.ops.transform import (
        forward_transform_batch, forward_transform_np,
        inverse_transform_batch)
    from turingcodec.ops.quant import (dequant_batch, dequant_np,
                                       quant_batch, quant_np)
    from turingcodec.ops.metrics import sad_batch, satd_batch, satd_np, ssd_batch
    from turingcodec.ops.intra import (
        intra_predict_all_modes, intra_predict_all_modes_np)
    from turingcodec.ops.inter import (
        interp_luma_all_phases, interp_luma_all_phases_np)

    rng = np.random.default_rng(seed)
    b = batch
    few = np.unique(np.linspace(0, b - 1, min(b, oracle_blocks))
                    .astype(np.int64))
    rows = []

    def run(name, fn, args, check, work, unit):
        got = np.asarray(fn(*args))
        rows.append((name, bool(check(got)), _bench(fn, args, iters),
                     work, unit))

    # transforms
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        d = rng.integers(-500, 500, (b, n, n)).astype(np.int32)
        jd = jnp.asarray(d)
        run(f"inverse_dct_{n}x{n}", inverse_transform_batch, (jd, 8, False),
            lambda g: np.array_equal(g, np.stack(
                [inverse_transform(x, 8, False) for x in d])),
            b * n * n, "samp")
        run(f"forward_dct_{n}x{n}", forward_transform_batch, (jd, 8, False),
            lambda g: np.array_equal(g, forward_transform_np(d, 8, False)),
            b * n * n, "samp")

    # quant / dequant
    lv = rng.integers(-3000, 3000, (b, 16, 16)).astype(np.int32)
    qp = np.full(b, 26, np.int32)
    run("dequant_16x16", dequant_batch,
        (jnp.asarray(lv), jnp.asarray(qp), 8, 4),
        lambda g: np.array_equal(g, dequant_np(lv, 26, 8, 4)),
        b * 256, "coef")
    rnd = np.full(b, 171 << 6, np.int32)
    run("quant_16x16", quant_batch,
        (jnp.asarray(lv), jnp.asarray(qp), 8, 4, jnp.asarray(rnd)),
        lambda g: np.array_equal(g, quant_np(lv, 26, 8, 4, 171 << 6)),
        b * 256, "coef")

    # metrics
    a8 = rng.integers(0, 256, (b, 16, 16)).astype(np.int32)
    b8 = rng.integers(0, 256, (b, 16, 16)).astype(np.int32)
    ja, jb = jnp.asarray(a8), jnp.asarray(b8)
    diff = a8.astype(np.int64) - b8
    run("sad_16x16", sad_batch, (ja, jb),
        lambda g: np.array_equal(g, np.abs(diff).sum((1, 2))),
        b * 256, "samp")
    run("satd8_16x16", satd_batch, (ja, jb, 8),
        lambda g: all(int(g[i]) == satd_np(a8[i], b8[i], 8) for i in few),
        b * 256, "samp")
    run("ssd_16x16", ssd_batch, (ja, jb),
        lambda g: np.array_equal(g, (diff * diff).sum((1, 2))),
        b * 256, "samp")

    # intra all modes
    for n in (8, 16, 32):
        rt = rng.integers(0, 256, (b, 2 * n + 1)).astype(np.int32)
        rl = rng.integers(0, 256, (b, 2 * n + 1)).astype(np.int32)
        co = rng.integers(0, 256, b).astype(np.int32)
        run(f"intra35_{n}x{n}", intra_predict_all_modes,
            (jnp.asarray(rt), jnp.asarray(rl), jnp.asarray(co), n),
            lambda g: np.array_equal(g[few], intra_predict_all_modes_np(
                rt[few], rl[few], co[few], n)),
            b * 35 * n * n, "samp")

    # interpolation all phases
    w = h = 16
    win = rng.integers(0, 256, (b, h + 7, w + 7)).astype(np.int16)
    run("interp16_luma_16x16", interp_luma_all_phases,
        (jnp.asarray(win), w, h),
        lambda g: np.array_equal(g[few].astype(np.int64),
                                 interp_luma_all_phases_np(win[few], w, h)),
        b * 16 * w * h, "samp")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec kernels")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--oracle-blocks", type=int, default=64)
    args = ap.parse_args(argv)

    import jax

    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    failures = 0
    for name, ok, t, work, unit in check_kernels(args.batch, args.iters,
                                                 args.oracle_blocks):
        failures += not ok
        print(f"{name:<28} {'OK ' if ok else 'FAIL'} {t * 1e3:8.3f} ms  "
              f"{work / t / 1e9:8.2f} G{unit}/s")

    # native SATD kernels (havoc_test analogue: optimized vs C template,
    # bit-exact required, ns/block reported)
    from turingcodec.native import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        lib.tc_satd_selftest.argtypes = [ctypes.c_int, ctypes.c_void_p]
        out = np.zeros(3, np.int64)
        iters = 20000
        lib.tc_satd_selftest(iters, out.ctypes.data)
        ok = out[0] == 0
        if not ok:
            failures += 1
        print(f"satd8_native      {'OK ' if ok else 'FAIL'}  "
              f"int32 {out[1] / iters / 16:6.2f} ns/blk   "
              f"int16 {out[2] / iters / 16:6.2f} ns/blk")

    print("ALL OK" if not failures else f"{failures} FAILURES")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
