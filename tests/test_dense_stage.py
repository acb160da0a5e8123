"""The XLA dense-ME stage (device_analysis._dense_stage) against the
brute-force selection rule: per 16x16 block, the (ox, oy) in [-8, 8]^2
around its seed minimizing (SAD << 2) + |ox| + |oy|, first in (oy, ox)
scan order on ties — and against the host twin with the same seeds."""
import numpy as np
import pytest

W, H = 80, 56    # 5x4 blocks; 56 is not a multiple of 16 (edge padding)
WB, HB = 5, 4
P = 48


def _brute_force(orig, ref, seeds):
    cur = np.pad(orig.astype(np.int64), ((0, HB * 16 - H), (0, WB * 16 - W)),
                 "edge")
    r = np.pad(ref.astype(np.int64), ((0, HB * 16 - H), (0, WB * 16 - W)),
               "edge")
    r = np.pad(r, P, "edge")
    mv = np.zeros((HB, WB, 2), np.int64)
    sads = np.zeros((HB, WB), np.int64)
    for by in range(HB):
        for bx in range(WB):
            blk = cur[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16]
            sx, sy = seeds[by, bx]
            best = None
            for oy in range(-8, 9):
                for ox in range(-8, 9):
                    y = by * 16 + sy + oy + P
                    x = bx * 16 + sx + ox + P
                    sad = np.abs(blk - r[y:y + 16, x:x + 16]).sum()
                    cost = (sad << 2) + abs(ox) + abs(oy)
                    if best is None or cost < best:
                        best = cost
                        mv[by, bx] = (sx + ox, sy + oy)
                        sads[by, bx] = sad
    return mv, sads


def _case(name):
    rng = np.random.default_rng(17)
    orig = rng.integers(0, 256, (H, W)).astype(np.int16)
    ref = rng.integers(0, 256, (H, W)).astype(np.int16)
    seeds = np.zeros((HB, WB, 2), np.int32)
    if name == "random":
        seeds = rng.integers(-4, 5, (HB, WB, 2)).astype(np.int32)
    elif name == "exact_matches":
        # block (1, 1) found at (+5, -3), block (2, 3) at (-8, +8) of a
        # nonzero seed, block (0, 0) at the picture edge
        ref[16 - 3:32 - 3, 16 + 5:32 + 5] = orig[16:32, 16:32]
        seeds[2, 3] = (2, -2)
        ref[32 - 2 + 8:48 - 2 + 8, 48 + 2 - 8:64 + 2 - 8] = orig[32:48, 48:64]
        ref[0:16, 0:16] = orig[0:16, 0:16]
    elif name == "penalty_ties":
        # flat block (1, 2) whose value occurs only in two regions at cost
        # 0*4 + 8 each: (-8, 0) and (0, +8); scan order keeps (-8, 0)
        orig[16:32, 32:48] = 7
        ref[ref == 7] = 8
        ref[16:32, 24:40] = 7
        ref[24:40, 32:48] = 7
    elif name == "flat":
        # equal SAD everywhere: the penalty alone picks (0, 0)
        orig[:] = 100
        ref[:] = 90
        seeds = rng.integers(-2, 3, (HB, WB, 2)).astype(np.int32)
    elif name == "pan":
        # the whole picture shifted by (+3, +2): interior blocks find it
        ref = np.roll(orig, (2, 3), (0, 1))
    return orig, ref, seeds


@pytest.mark.parametrize("name", ["random", "exact_matches", "penalty_ties",
                                  "flat", "pan"])
def test_dense_stage_matches_brute_force(name):
    import jax
    import jax.numpy as jnp

    from turingcodec.encode.device_analysis import _dense_stage
    from turingcodec.encode.inter_search import InterPictureEncoder

    orig, ref, seeds = _case(name)
    fn = jax.jit(lambda o, r, s: _dense_stage(o, r, s, W, H, WB, HB))
    mv, sad = (np.asarray(a) for a in fn(jnp.asarray(orig), jnp.asarray(ref),
                                         jnp.asarray(seeds)))
    want_mv, want_sad = _brute_force(orig, ref, seeds)
    np.testing.assert_array_equal(mv, want_mv)
    np.testing.assert_array_equal(sad, want_sad)

    # the host twin, fed the same seeds
    host = InterPictureEncoder.__new__(InterPictureEncoder)
    host._lr_seed_cache = {id(ref): (seeds, WB, HB)}
    host._dense_cache = {}
    host.orig = [orig]
    hmv, hsad, _, _ = host._dense_field(ref)
    np.testing.assert_array_equal(hmv, want_mv)
    np.testing.assert_array_equal(hsad, want_sad)

    if name == "exact_matches":
        assert tuple(mv[1, 1]) == (5, -3) and sad[1, 1] == 0
        assert tuple(mv[2, 3]) == (-6, 6) and sad[2, 3] == 0
        assert tuple(mv[0, 0]) == (0, 0) and sad[0, 0] == 0
    elif name == "penalty_ties":
        assert tuple(mv[1, 2]) == (-8, 0) and sad[1, 2] == 0
    elif name == "flat":
        np.testing.assert_array_equal(mv, seeds)
