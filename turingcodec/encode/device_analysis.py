"""Device (XLA) encoder pre-analysis stages, run when the Encoder's
`device` choice is on (EncoderConfig.device; by default on a GPU backend).

The encoder's per-picture *data-parallel* analysis runs as one jitted XLA
program per reference plane, feeding the (sequential, host) RDO exactly
the numbers its own kernels would have produced — the bitstream is
bit-identical with the host path by construction (integer arithmetic,
same tie-breaks). Covered here:

- lowres pre-ME seed fields (enc_core.cpp lowres_prepass /
  inter_search._lowres_seed_field twins): quarter-res exhaustive +/-8 SAD
  per 16x16 block with cost (SAD<<2)+|dx|+|dy| and scan-order tie-breaks,
  then half-res +/-2 refinement. This is the encoder's one
  whole-picture-dense pixel sweep (289 SAD maps over the full frame) —
  batched work suited to the device, unlike the adaptive per-PU pattern
  search it seeds.
- the dense +/-8 full-pel ME field and its winner SADs, the subpel
  planes, and the source-referenced rank-SATD tables.

The reference's analogous pre-analysis is host C++ (SCDetection.h,
AdaptiveQuantisation.h, and the seeded ME of Search.hpp:2064); here it is
a jax.jit program so multi-device meshes can shard pictures of a GOP
across devices (parallel/: the 'frame' mesh axis).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

_JIT_CACHE = {}


def device_enc_enabled(device: bool) -> bool:
    """The device analysis runs when the encoder's device choice is on,
    unless TC_NO_LOWRES turns the whole pre-ME off."""
    return bool(device) and not os.environ.get("TC_NO_LOWRES")


def _lowres_plane_j(src, f, b, wb, hb, border):
    """jnp twin of enc_core lowres_plane<F,B> (edge-clamped decimation by
    rounded mean, padded to (hb*b, wb*b) + border)."""
    import jax.numpy as jnp
    h, w = src.shape
    lw, lh = -(-w // f), -(-h // f)
    p = jnp.pad(src.astype(jnp.int32),
                ((0, lh * f - h), (0, lw * f - w)), "edge")
    lr = (p.reshape(lh, f, lw, f).sum((1, 3)) + f * f // 2) // (f * f)
    lr = jnp.pad(lr, ((0, hb * b - lh), (0, wb * b - lw)), "edge")
    if border:
        lr = jnp.pad(lr, border, "edge")
    return lr


def _seed_field_program(w: int, h: int):
    """Build the jitted (orig, ref) -> (hb, wb, 2) int32 seed program for a
    fixed picture size."""
    import jax
    import jax.numpy as jnp

    lw, lh = -(-w // 4), -(-h // 4)
    wb, hb = -(-lw // 4), -(-lh // 4)

    offs_q = jnp.array([(dy, dx) for dy in range(-8, 9)
                        for dx in range(-8, 9)], jnp.int32)
    offs_h = jnp.array([(dy, dx) for dy in range(-2, 3)
                        for dx in range(-2, 3)], jnp.int32)

    def seed_field(orig, ref):
        cur4 = _lowres_plane_j(orig, 4, 4, wb, hb, 0)
        ref4 = _lowres_plane_j(ref, 4, 4, wb, hb, 8)

        # quarter-res exhaustive +/-8: scan in (dy, dx) ascending order,
        # strict improvement == numpy argmin's first-minimum tie-break
        def qstep(carry, off):
            dy, dx = off[0], off[1]
            win = jax.lax.dynamic_slice(ref4, (8 + dy, 8 + dx),
                                        (hb * 4, wb * 4))
            d = jnp.abs(cur4 - win)
            c = (d.reshape(hb, 4, wb, 4).sum((1, 3)) << 2) \
                + jnp.abs(dx) + jnp.abs(dy)
            bc, bdx, bdy = carry
            m = c < bc
            return (jnp.where(m, c, bc), jnp.where(m, dx, bdx),
                    jnp.where(m, dy, bdy)), None

        big = jnp.full((hb, wb), np.iinfo(np.int32).max, jnp.int32)
        zeros = jnp.zeros((hb, wb), jnp.int32)
        (qc, sdx, sdy), _ = jax.lax.scan(qstep, (big, zeros, zeros), offs_q)

        # half-res +/-2 refinement around (2*sdx, 2*sdy) half-pels
        cur8 = _lowres_plane_j(orig, 2, 8, wb, hb, 0)
        ref8 = _lowres_plane_j(ref, 2, 8, wb, hb, 24)
        cb = cur8.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)
        by = jnp.arange(hb)[:, None]
        bx = jnp.arange(wb)[None, :]
        chy, chx = 2 * sdy, 2 * sdx
        ay = jnp.arange(8)

        def hstep(carry, off):
            dy, dx = off[0], off[1]
            ys = (by * 8 + chy + dy + 24)[:, :, None, None] \
                + ay[None, None, :, None]
            xs = (bx * 8 + chx + dx + 24)[:, :, None, None] \
                + ay[None, None, None, :]
            sad = jnp.abs(cb - ref8[ys, xs]).sum((2, 3))
            sx, sy = 2 * (chx + dx), 2 * (chy + dy)
            c = (sad << 2) + jnp.abs(sx) + jnp.abs(sy)
            bc, bsx, bsy = carry
            m = c < bc
            return (jnp.where(m, c, bc), jnp.where(m, sx, bsx),
                    jnp.where(m, sy, bsy)), None

        (hc, bsx, bsy), _ = jax.lax.scan(
            hstep, (big, zeros, zeros), offs_h)
        return jnp.stack([bsx, bsy], -1)

    return seed_field, wb, hb


def _dense_stage(orig, ref, seeds, w, h, wb, hb, want_surf=False):
    """jnp twin of enc_core dense_search_rows + dense_pad_plane: per 16x16
    block, the exhaustive +/-8 full-pel SAD winner around the lowres seed
    over edge-replicated padded planes; cost = (SAD << 2) + |ox| + |oy|,
    scan-order (oy, ox) strict-improvement tie-break. Integer-exact with
    the host twins (inter_search._dense_field / native dense_prepass)."""
    import jax
    import jax.numpy as jnp
    P = 48
    cur = jnp.pad(orig.astype(jnp.int32),
                  ((0, hb * 16 - h), (0, wb * 16 - w)), "edge")
    r = jnp.pad(ref.astype(jnp.int32),
                ((0, hb * 16 - h), (0, wb * 16 - w)), "edge")
    r = jnp.pad(r, P, "edge")
    cb = cur.reshape(hb, 16, wb, 16).transpose(0, 2, 1, 3)
    by = jnp.arange(hb)[:, None]
    bx = jnp.arange(wb)[None, :]
    a32 = jnp.arange(32)
    ys = (by * 16 + seeds[:, :, 1] - 8 + P)[:, :, None, None] \
        + a32[None, None, :, None]
    xs = (bx * 16 + seeds[:, :, 0] - 8 + P)[:, :, None, None] \
        + a32[None, None, None, :]
    patch = r[ys, xs]  # (hb, wb, 32, 32)
    offs = jnp.array([(oy, ox) for oy in range(17) for ox in range(17)],
                     jnp.int32)
    if want_surf:
        # keep the whole 17x17 SAD surface (the full-pel search serves
        # aligned probes out of it — exact integers); the winner derives
        # from the same tensor, argmin's first-minimum == the scan
        # order's strict-improvement tie-break
        def sad_of(off):
            win = jax.lax.dynamic_slice(patch, (0, 0, off[0], off[1]),
                                        (hb, wb, 16, 16))
            return jnp.abs(cb - win).sum((2, 3))

        sads = jax.lax.map(sad_of, offs)  # (289, hb, wb)
        pen = (jnp.abs(offs[:, 1] - 8)
               + jnp.abs(offs[:, 0] - 8))[:, None, None]
        cost = (sads << 2) + pen
        k = jnp.argmin(cost.reshape(17 * 17, hb * wb), axis=0)
        box = (k % 17 - 8).reshape(hb, wb)
        boy = (k // 17 - 8).reshape(hb, wb)
        bsad = jnp.take_along_axis(
            sads.reshape(17 * 17, hb * wb), k[None], axis=0
        )[0].reshape(hb, wb)
        surf = sads.transpose(1, 2, 0).reshape(hb * wb, 17 * 17)
        return (jnp.stack([seeds[:, :, 0] + box,
                           seeds[:, :, 1] + boy], -1), bsad, surf)

    big = jnp.full((hb, wb), np.iinfo(np.int32).max, jnp.int32)
    zeros = jnp.zeros((hb, wb), jnp.int32)

    def step(carry, off):
        oy, ox = off[0], off[1]
        win = jax.lax.dynamic_slice(patch, (0, 0, oy, ox),
                                    (hb, wb, 16, 16))
        sad = jnp.abs(cb - win).sum((2, 3))
        cost = (sad << 2) + jnp.abs(ox - 8) + jnp.abs(oy - 8)
        bc, bs, bdx, bdy = carry
        m = cost < bc
        return (jnp.where(m, cost, bc), jnp.where(m, sad, bs),
                jnp.where(m, ox - 8, bdx),
                jnp.where(m, oy - 8, bdy)), None

    (_, bsad, box, boy), _ = jax.lax.scan(step, (big, zeros, zeros, zeros),
                                          offs)
    return (jnp.stack([seeds[:, :, 0] + box, seeds[:, :, 1] + boy], -1),
            bsad)


def _analysis_program(w: int, h: int):
    """Fused (orig, ref) -> (seed_field, dense_field) program: the lowres
    pre-ME and the dense full-pel ME sweep in ONE jit dispatch."""
    seed_field, wb, hb = _seed_field_program(w, h)

    def analysis(orig, ref):
        seeds = seed_field(orig, ref)
        dense, dsad = _dense_stage(orig, ref, seeds, w, h, wb, hb)
        return seeds, dense, dsad

    return analysis, wb, hb


def _analysis_surf_program(w: int, h: int):
    """As _analysis_program, plus the dense sweep\'s full (hb*wb, 17*17)
    SAD surface (exact host-twin integers)."""
    seed_field, wb, hb = _seed_field_program(w, h)

    def analysis(orig, ref):
        seeds = seed_field(orig, ref)
        dense, dsad, surf = _dense_stage(orig, ref, seeds, w, h, wb, hb,
                                         want_surf=True)
        return seeds, dense, dsad, surf

    return analysis, wb, hb


def analysis_device(orig_y: np.ndarray, ref_y: np.ndarray,
                    want_surf: bool = False):
    """Compute one reference plane's (seed, dense, sad) fields on device —
    integer-exact with the host lowres_prepass + dense_prepass. With
    want_surf, additionally the dense sweep's full (hb*wb, 17*17) SAD
    surface (the tensor the full-pel search serves aligned probes from)."""
    import jax
    h, w = orig_y.shape
    if want_surf:
        key = ("analysissurf", w, h)
        if key not in _JIT_CACHE:
            raw, wb, hb = _analysis_surf_program(w, h)
            _JIT_CACHE[key] = (jax.jit(raw), wb, hb)
        fn, wb, hb = _JIT_CACHE[key]
        sm, dm, ds, surf = fn(np.asarray(orig_y, np.int16),
                              np.asarray(ref_y, np.int16))
        return (np.asarray(sm).astype(np.int32),
                np.asarray(dm).astype(np.int32),
                np.asarray(ds).astype(np.int32), wb, hb,
                np.asarray(surf).astype(np.int32))
    key = ("analysis", w, h)
    if key not in _JIT_CACHE:
        raw, wb, hb = _analysis_program(w, h)
        _JIT_CACHE[key] = (jax.jit(raw), wb, hb)
    fn, wb, hb = _JIT_CACHE[key]
    sm, dm, ds = fn(np.asarray(orig_y, np.int16),
                    np.asarray(ref_y, np.int16))
    return (np.asarray(sm).astype(np.int32),
            np.asarray(dm).astype(np.int32),
            np.asarray(ds).astype(np.int32), wb, hb)


def analysis_frames_sharded(mesh, origs: np.ndarray, refs: np.ndarray):
    """GOP-batched encoder analysis (lowres pre-ME + dense full-pel ME
    fields + winner SADs) for N (orig, ref) picture pairs in one jit,
    sharded over the mesh 'frame' axis — the 2+-picture-overlap form of
    the production device-analysis stage (each in-flight picture of
    the concurrent-frame encoder computes its analysis on its own mesh
    slice). Values are integer-exact twins of the host prepass."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    n, h, w = origs.shape
    key = ("analysisraw", w, h)
    if key not in _JIT_CACHE:
        _JIT_CACHE[key] = _analysis_program(w, h)
    raw, wb, hb = _JIT_CACHE[key]
    sh = NamedSharding(mesh, P("frame"))
    fn = jax.jit(jax.vmap(raw), in_shardings=(sh, sh),
                 out_shardings=(sh, sh, sh))
    a = jax.device_put(np.asarray(origs, np.int16), sh)
    b = jax.device_put(np.asarray(refs, np.int16), sh)
    sm, dm, ds = fn(a, b)
    return (np.asarray(sm).astype(np.int32),
            np.asarray(dm).astype(np.int32),
            np.asarray(ds).astype(np.int32), wb, hb)


def seed_fields_frames_sharded(mesh, origs: np.ndarray, refs: np.ndarray):
    """GOP-batched pre-ME: seed fields for N (orig, ref) picture pairs in
    one jit, sharded over the mesh 'frame' axis — the encoder-analysis
    stage of the multi-chip scale-out story (each picture's pre-ME is
    data-parallel; only the sequential RDO chains pictures). Values are
    integer-exact twins of the host lowres_prepass."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    n, h, w = origs.shape
    key = ("seedraw", w, h)
    if key not in _JIT_CACHE:
        _JIT_CACHE[key] = _seed_field_program(w, h)
    raw, wb, hb = _JIT_CACHE[key]
    sh = NamedSharding(mesh, P("frame"))
    fn = jax.jit(jax.vmap(raw), in_shardings=(sh, sh),
                 out_shardings=sh)
    a = jax.device_put(np.asarray(origs, np.int16), sh)
    b = jax.device_put(np.asarray(refs, np.int16), sh)
    return np.asarray(fn(a, b)).astype(np.int32), wb, hb


def seed_field_device(orig_y: np.ndarray, ref_y: np.ndarray):
    """Compute one reference plane's seed field on device; returns
    (seed_mv (hb, wb, 2) int32 numpy, wb, hb) — the exact value of
    inter_search._lowres_seed_field / enc_core lowres_prepass."""
    import jax
    h, w = orig_y.shape
    key = ("seed", w, h)
    if key not in _JIT_CACHE:
        raw, wb, hb = _seed_field_program(w, h)
        _JIT_CACHE[key] = (jax.jit(raw), wb, hb)
    fn, wb, hb = _JIT_CACHE[key]
    out = np.asarray(fn(np.asarray(orig_y, np.int16),
                        np.asarray(ref_y, np.int16)))
    return out.astype(np.int32), wb, hb


SP_P = 28   # stored-plane pad (enc_core SP_P)
SP_EXT2 = 36  # edge pad so every clamped tap read is a plain slice


def _subpel_planes_program(w: int, h: int, bd: int):
    """Jitted ref-plane -> (15, h+2*SP_P, w+2*SP_P) int16 program: the 15
    fractional luma positions interpolated over the padded grid, each
    value bit-equal to enc_core sp_build_plane (edge-replicated padding ==
    per-sample coordinate clamping; same >>shift1 / >>6 arithmetic)."""
    import jax
    import jax.numpy as jnp

    from turingcodec.hevc.tables import LUMA_FILTER
    filt = np.asarray(LUMA_FILTER, np.int32)  # (4 phases, 8 taps)
    shift1 = bd - 8
    pw, ph = w + 2 * SP_P, h + 2 * SP_P
    pwe, phe = w + 2 * (SP_P + 4), h + 2 * (SP_P + 4)

    def planes(ref):
        ext2 = jnp.pad(ref.astype(jnp.int32), SP_EXT2, "edge")
        # H-filtered intermediates for xf=1..3 over the full ext grid
        # (rows phe so the 2D V pass can reach its taps)
        hplanes = {}
        for xf in (1, 2, 3):
            acc = sum(int(filt[xf][k])
                      * jax.lax.dynamic_slice(ext2, (4, 1 + k), (phe, pwe))
                      for k in range(8))
            hplanes[xf] = jnp.right_shift(acc, shift1) if shift1 else acc
        out = []
        for yf in range(4):
            for xf in range(4):
                if xf == 0 and yf == 0:
                    continue
                if yf == 0:
                    p = jax.lax.dynamic_slice(hplanes[xf], (4, 4),
                                              (ph, pw))
                elif xf == 0:
                    acc = sum(int(filt[yf][k]) * jax.lax.dynamic_slice(
                        ext2, (5 + k, 8), (ph, pw)) for k in range(8))
                    p = jnp.right_shift(acc, shift1) if shift1 else acc
                else:
                    acc = sum(int(filt[yf][k]) * jax.lax.dynamic_slice(
                        hplanes[xf], (1 + k, 4), (ph, pw))
                        for k in range(8))
                    p = jnp.right_shift(acc, 6)
                out.append(p.astype(jnp.int16))
        return jnp.stack(out)

    import jax
    return jax.jit(planes)


def subpel_planes_host(ref_y: np.ndarray, bd: int = 8) -> np.ndarray:
    """Vectorized numpy twin of subpel_planes_device / sp_build_plane
    (full-plane oracle for the real-chip exactness check)."""
    from turingcodec.hevc.tables import LUMA_FILTER
    filt = np.asarray(LUMA_FILTER, np.int32)
    h, w = ref_y.shape
    shift1 = bd - 8
    pw, ph = w + 2 * SP_P, h + 2 * SP_P
    pwe, phe = w + 2 * (SP_P + 4), h + 2 * (SP_P + 4)
    ext2 = np.pad(ref_y.astype(np.int32), SP_EXT2, "edge")
    hplanes = {}
    for xf in (1, 2, 3):
        acc = sum(int(filt[xf][k]) * ext2[4:4 + phe, 1 + k:1 + k + pwe]
                  for k in range(8))
        hplanes[xf] = acc >> shift1 if shift1 else acc
    out = []
    for yf in range(4):
        for xf in range(4):
            if xf == 0 and yf == 0:
                continue
            if yf == 0:
                p = hplanes[xf][4:4 + ph, 4:4 + pw]
            elif xf == 0:
                acc = sum(int(filt[yf][k])
                          * ext2[5 + k:5 + k + ph, 8:8 + pw]
                          for k in range(8))
                p = acc >> shift1 if shift1 else acc
            else:
                acc = sum(int(filt[yf][k])
                          * hplanes[xf][1 + k:1 + k + ph, 4:4 + pw]
                          for k in range(8))
                p = acc >> 6
            out.append(p.astype(np.int16))
    return np.stack(out)


def subpel_planes_device(ref_y: np.ndarray, bd: int = 8) -> np.ndarray:
    """Compute the 15 subpel planes of one reference plane on device;
    (15, h+2*SP_P, w+2*SP_P) int16, exact sp_build_plane values."""
    h, w = ref_y.shape
    key = ("subpel", w, h, bd)
    if key not in _JIT_CACHE:
        _JIT_CACHE[key] = _subpel_planes_program(w, h, bd)
    return np.asarray(_JIT_CACHE[key](np.asarray(ref_y, np.int16)))


def _rank_grid_refs(plane, zscan, n, bd):
    """Batched source-referenced intra reference samples for every
    in-picture n-aligned block: returns vals (hn*wn, 4n+1) int32 in scan
    order (left bottom-up, corner, top), with spec 8.4.4.2.2
    availability substitution (z-scan positional availability — the
    simple single-slice/no-tile case the prepass supports)."""
    h, w = plane.shape
    hn, wn = h // n, w // n
    m = 4 * n + 1
    tx = np.empty(m, np.int32)
    ty = np.empty(m, np.int32)
    tx[:2 * n + 1] = -1
    tx[2 * n + 1:] = np.arange(2 * n)
    ty[:2 * n] = 2 * n - 1 - np.arange(2 * n)
    ty[2 * n:] = -1
    bx = (np.arange(wn) * n)[None, :, None]
    by = (np.arange(hn) * n)[:, None, None]
    px = bx + tx[None, None, :]
    py = by + ty[None, None, :]
    inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
    pxc = np.clip(px, 0, w - 1)
    pyc = np.clip(py, 0, h - 1)
    zcur = zscan[by[:, :, 0] >> 2, bx[:, :, 0] >> 2][:, :, None]
    ok = inb & (zscan[pyc >> 2, pxc >> 2] <= zcur)
    vals = plane[pyc, pxc].astype(np.int32)
    vals = vals.reshape(-1, m)
    ok = ok.reshape(-1, m)
    mid = 1 << (bd - 1)
    any_ok = ok.any(axis=1)
    first = np.argmax(ok, axis=1)
    b = np.arange(vals.shape[0])
    vals[:, 0] = np.where(ok[:, 0], vals[:, 0], vals[b, first])
    ok[:, 0] = True
    vals = np.where(ok, vals, 0)
    src = np.where(ok, np.arange(m)[None, :], 0)
    np.maximum.accumulate(src, axis=1, out=src)
    vals = vals[b[:, None], src]
    vals = np.where(any_ok[:, None], vals, mid)
    return vals


def _filter_grid_refs(vals, n, strong, bd):
    """Batched spec 8.4.4.2.3 reference filtering of scan-order vals
    (B, 4n+1): [1 2 1] smoothing, with the strong bilinear variant at
    n == 32 when the flatness thresholds pass."""
    B, m = vals.shape
    co = vals[:, 2 * n]
    rl = vals[:, :2 * n][:, ::-1]  # rl[i] = p[-1][i] top-down
    rt = vals[:, 2 * n + 1:]
    ft = np.empty_like(rt)
    fl = np.empty_like(rl)
    ft[:, 0] = (co + 2 * rt[:, 0] + rt[:, 1] + 2) >> 2
    fl[:, 0] = (co + 2 * rl[:, 0] + rl[:, 1] + 2) >> 2
    ft[:, 1:2 * n - 1] = (rt[:, :2 * n - 2] + 2 * rt[:, 1:2 * n - 1]
                          + rt[:, 2:] + 2) >> 2
    fl[:, 1:2 * n - 1] = (rl[:, :2 * n - 2] + 2 * rl[:, 1:2 * n - 1]
                          + rl[:, 2:] + 2) >> 2
    ft[:, 2 * n - 1] = rt[:, 2 * n - 1]
    fl[:, 2 * n - 1] = rl[:, 2 * n - 1]
    fc = (rl[:, 0] + 2 * co + rt[:, 0] + 2) >> 2
    if strong and n == 32:
        t1 = np.abs(co + rt[:, 2 * n - 1] - 2 * rt[:, n - 1])
        t2 = np.abs(co + rl[:, 2 * n - 1] - 2 * rl[:, n - 1])
        is_str = (t1 < (1 << (bd - 5))) & (t2 < (1 << (bd - 5)))
        i = np.arange(63)
        st = ((63 - i)[None, :] * co[:, None]
              + (i + 1)[None, :] * rt[:, 63][:, None] + 32) >> 6
        sl = ((63 - i)[None, :] * co[:, None]
              + (i + 1)[None, :] * rl[:, 63][:, None] + 32) >> 6
        ft[:, :63] = np.where(is_str[:, None], st, ft[:, :63])
        fl[:, :63] = np.where(is_str[:, None], sl, fl[:, :63])
        ft[:, 63] = np.where(is_str, rt[:, 63], ft[:, 63])
        fl[:, 63] = np.where(is_str, rl[:, 63], fl[:, 63])
        fc = np.where(is_str, co, fc)
    out = np.empty_like(vals)
    out[:, :2 * n] = fl[:, ::-1]
    out[:, 2 * n] = fc
    out[:, 2 * n + 1:] = ft
    return out


def _grid_mode_satds(orig_blocks, vals, fvals, n, bd):
    """(B, n, n) originals + scan-order refs -> (B, 35) SATDs, matching
    intra_search._mode_satds (per-mode filtered/unfiltered choice, no
    edge filters in the ranking predictions)."""
    from turingcodec.decode.reconstruct import _HVD_THRES
    from turingcodec.encode.sweep import _h4, _h8, _stacked_tables
    B = vals.shape[0]
    rl = vals[:, :2 * n][:, ::-1]
    co = vals[:, 2 * n]
    rt = vals[:, 2 * n + 1:]
    x = np.arange(n)
    log2n = int(n).bit_length() - 1
    out = np.empty((B, 35), np.int64)
    block = 8 if n >= 8 else 4
    hb = _h8() if block == 8 else _h4()
    d0 = orig_blocks.astype(np.int32)

    def satd(preds):  # (B, M, n, n) -> (B, M)
        mm = preds.shape[1]
        d = d0[:, None] - preds
        bh = n // block
        d = d.reshape(B, mm, bh, block, bh, block).transpose(
            0, 1, 2, 4, 3, 5)
        t = hb @ d @ hb
        s = np.abs(t).sum(axis=(4, 5))
        s = (s + 2) >> 2 if block == 8 else (s + 1) >> 1
        return s.sum(axis=(2, 3)).astype(np.int64)

    use_f = np.zeros(35, bool)
    if n > 4:
        thres = _HVD_THRES[n]
        for mode in range(35):
            if mode == 1:
                continue
            if mode != 0 and min(abs(mode - 26), abs(mode - 10)) <= thres:
                continue
            use_f[mode] = True

    frl = fvals[:, :2 * n][:, ::-1] if fvals is not None else rl
    fco = fvals[:, 2 * n] if fvals is not None else co
    frt = fvals[:, 2 * n + 1:] if fvals is not None else rt

    # planar + DC from the per-mode-appropriate refs
    def planar(rt_, rl_):
        return (((n - 1 - x)[None, None, :] * rl_[:, :n, None]
                 + (x + 1)[None, None, :] * rt_[:, n][:, None, None]
                 + (n - 1 - x)[None, :, None] * rt_[:, None, :n]
                 + (x + 1)[None, :, None] * rl_[:, n][:, None, None]
                 + n) >> (log2n + 1)).astype(np.int32)

    p0 = planar(frt, frl) if use_f[0] else planar(rt, rl)
    rtd, rld = (frt, frl) if use_f[1] else (rt, rl)
    dc = ((rtd[:, :n].sum(axis=1) + rld[:, :n].sum(axis=1) + n)
          >> (log2n + 1))
    p1 = np.broadcast_to(dc[:, None, None].astype(np.int32),
                         (B, n, n)).copy()
    out[:, 0] = satd(p0[:, None])[:, 0]
    out[:, 1] = satd(p1[:, None])[:, 0]

    # angular modes via the stacked gather tables, one ext per variant
    pos0, fact, neg = _stacked_tables(n)

    def build_ext(rt_, rl_, co_):
        ext = np.empty((B, 33, 3 * n + 2), np.int32)
        ext[:, :16, :n] = np.where(neg[None, :16] < 0, co_[:, None, None],
                                   rt_[:, np.maximum(neg[:16], 0)])
        ext[:, 16:, :n] = np.where(neg[None, 16:] < 0, co_[:, None, None],
                                   rl_[:, np.maximum(neg[16:], 0)])
        ext[:, :, n] = co_[:, None]
        ext[:, :16, n + 1:3 * n + 1] = rl_[:, None, :2 * n]
        ext[:, 16:, n + 1:3 * n + 1] = rt_[:, None, :2 * n]
        ext[:, :16, 3 * n + 1] = rl_[:, 2 * n - 1][:, None]
        ext[:, 16:, 3 * n + 1] = rt_[:, 2 * n - 1][:, None]
        return ext.reshape(B, -1)

    ext_u = build_ext(rt, rl, co)
    ext_f = build_ext(frt, frl, fco) if n > 4 else ext_u
    bidx = np.arange(B)[:, None, None, None]
    pf = pos0[None]
    gu = ext_u[bidx, pf]
    g1u = ext_u[bidx, pf + 1]
    pu = ((32 - fact[None]) * gu + fact[None] * g1u + 16) >> 5
    if n > 4:
        gf = ext_f[bidx, pf]
        g1f = ext_f[bidx, pf + 1]
        pfa = ((32 - fact[None]) * gf + fact[None] * g1f + 16) >> 5
        sel = use_f[2:][None, :, None, None]
        pang = np.where(sel, pfa, pu)
    else:
        pang = pu
    out[:, 2:] = satd(pang.astype(np.int32))
    return out


def rank_satd_tables_host(plane, zscan, bd, strong, sizes=(4, 8, 16, 32)):
    """Source-referenced 35-mode SATD tables for every aligned block of
    each size: {n: (hn, wn, 35) int32}. The exact integers the in-loop
    rank computes at those positions (intra_search._mode_satds /
    enc_core rank_modes sweep with source refs)."""
    plane = np.asarray(plane)
    out = {}
    for n in sizes:
        h, w = plane.shape
        hn, wn = h // n, w // n
        if hn == 0 or wn == 0:
            continue
        vals = _rank_grid_refs(plane, zscan, n, bd)
        fvals = _filter_grid_refs(vals, n, strong, bd) if n > 4 else None
        ob = plane[:hn * n, :wn * n].reshape(hn, n, wn, n) \
            .transpose(0, 2, 1, 3).reshape(-1, n, n)
        satds = _grid_mode_satds(ob, vals, fvals, n, bd)
        out[n] = satds.reshape(hn, wn, 35).astype(np.int32)
    return out


def _rank_tables_program(w, h, n, bd, strong, zscan_np):
    """Jitted plane -> (hn, wn, 35) int32 rank-SATD table for one size:
    the XLA twin of rank_satd_tables_host (identical integers)."""
    import jax
    import jax.numpy as jnp

    from turingcodec.decode.reconstruct import _HVD_THRES
    from turingcodec.encode.sweep import _h4, _h8, _stacked_tables
    hn, wn = h // n, w // n
    B = hn * wn
    m = 4 * n + 1
    tx = np.empty(m, np.int32)
    ty = np.empty(m, np.int32)
    tx[:2 * n + 1] = -1
    tx[2 * n + 1:] = np.arange(2 * n)
    ty[:2 * n] = 2 * n - 1 - np.arange(2 * n)
    ty[2 * n:] = -1
    bx = (np.arange(wn) * n)[None, :, None]
    by = (np.arange(hn) * n)[:, None, None]
    px = np.broadcast_to(bx + tx[None, None, :], (hn, wn, m)) \
        .reshape(B, m)
    py = np.broadcast_to(by + ty[None, None, :], (hn, wn, m)) \
        .reshape(B, m)
    inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
    pxc = np.clip(px, 0, w - 1)
    pyc = np.clip(py, 0, h - 1)
    zcur = zscan_np[by[:, :, 0] >> 2, bx[:, :, 0] >> 2].reshape(B, 1)
    ok_np = inb & (zscan_np[pyc >> 2, pxc >> 2] <= zcur)  # static per geom
    mid = 1 << (bd - 1)
    x = np.arange(n)
    log2n = int(n).bit_length() - 1
    block = 8 if n >= 8 else 4
    hb = np.asarray(_h8() if block == 8 else _h4())
    pos0, fact, neg = _stacked_tables(n)
    use_f = np.zeros(35, bool)
    if n > 4:
        thres = _HVD_THRES[n]
        for mode in range(35):
            if mode == 1:
                continue
            if mode != 0 and min(abs(mode - 26), abs(mode - 10)) <= thres:
                continue
            use_f[mode] = True
    # per-mode ext gather indices relative to the mode's own ext row
    pos_rel = (np.asarray(pos0)
               - (np.arange(33, dtype=np.int64) * (3 * n + 2))[:, None,
                                                               None])
    negc = np.maximum(np.asarray(neg), 0)
    neg_is_c = np.asarray(neg) < 0

    def program(plane):
        p32 = plane.astype(jnp.int32)
        vals = p32[pyc, pxc]  # (B, m) — static index arrays
        ok = jnp.asarray(ok_np)
        any_ok = ok.any(axis=1)
        first = jnp.argmax(ok, axis=1)
        barange = jnp.arange(B)
        vals = vals.at[:, 0].set(
            jnp.where(ok[:, 0], vals[:, 0], vals[barange, first]))
        ok = ok.at[:, 0].set(True)
        vals = jnp.where(ok, vals, 0)
        src = jnp.where(ok, jnp.arange(m)[None, :], 0)
        src = jax.lax.cummax(src, axis=1)
        vals = jnp.take_along_axis(vals, src, axis=1)
        vals = jnp.where(any_ok[:, None], vals, mid)

        rl = vals[:, :2 * n][:, ::-1]
        co = vals[:, 2 * n]
        rt = vals[:, 2 * n + 1:]
        if n > 4:
            ft0 = (co + 2 * rt[:, 0] + rt[:, 1] + 2) >> 2
            fl0 = (co + 2 * rl[:, 0] + rl[:, 1] + 2) >> 2
            ftm = (rt[:, :2 * n - 2] + 2 * rt[:, 1:2 * n - 1]
                   + rt[:, 2:] + 2) >> 2
            flm = (rl[:, :2 * n - 2] + 2 * rl[:, 1:2 * n - 1]
                   + rl[:, 2:] + 2) >> 2
            frt = jnp.concatenate([ft0[:, None], ftm,
                                   rt[:, 2 * n - 1][:, None]], axis=1)
            frl = jnp.concatenate([fl0[:, None], flm,
                                   rl[:, 2 * n - 1][:, None]], axis=1)
            fco = (rl[:, 0] + 2 * co + rt[:, 0] + 2) >> 2
            if strong and n == 32:
                t1 = jnp.abs(co + rt[:, 2 * n - 1] - 2 * rt[:, n - 1])
                t2 = jnp.abs(co + rl[:, 2 * n - 1] - 2 * rl[:, n - 1])
                is_str = (t1 < (1 << (bd - 5))) & (t2 < (1 << (bd - 5)))
                i = jnp.arange(63)
                st = ((63 - i)[None, :] * co[:, None]
                      + (i + 1)[None, :] * rt[:, 63][:, None] + 32) >> 6
                sl = ((63 - i)[None, :] * co[:, None]
                      + (i + 1)[None, :] * rl[:, 63][:, None] + 32) >> 6
                frt = jnp.where(is_str[:, None],
                                jnp.concatenate(
                                    [st, rt[:, 63][:, None]], axis=1), frt)
                frl = jnp.where(is_str[:, None],
                                jnp.concatenate(
                                    [sl, rl[:, 63][:, None]], axis=1), frl)
                fco = jnp.where(is_str, co, fco)
        else:
            frt, frl, fco = rt, rl, co

        ob = p32[:hn * n, :wn * n].reshape(hn, n, wn, n) \
            .transpose(0, 2, 1, 3).reshape(B, n, n)

        def satd1(pred):  # (B, n, n) -> (B,)
            d = ob - pred
            bh_ = n // block
            d = d.reshape(B, bh_, block, bh_, block).transpose(0, 1, 3, 2,
                                                               4)
            t = jnp.asarray(hb) @ d @ jnp.asarray(hb)
            s = jnp.abs(t).sum(axis=(3, 4))
            s = (s + 2) >> 2 if block == 8 else (s + 1) >> 1
            return s.sum(axis=(1, 2))

        def planar(rt_, rl_):
            return (((n - 1 - x)[None, None, :] * rl_[:, :n, None]
                     + (x + 1)[None, None, :] * rt_[:, n][:, None, None]
                     + (n - 1 - x)[None, :, None] * rt_[:, None, :n]
                     + (x + 1)[None, :, None] * rl_[:, n][:, None, None]
                     + n) >> (log2n + 1))

        s0 = satd1(planar(frt, frl) if use_f[0] else planar(rt, rl))
        rtd, rld = (frt, frl) if use_f[1] else (rt, rl)
        dc = ((rtd[:, :n].sum(axis=1) + rld[:, :n].sum(axis=1) + n)
              >> (log2n + 1))
        s1 = satd1(jnp.broadcast_to(dc[:, None, None], (B, n, n)))

        use_f_ang = jnp.asarray(use_f[2:])

        def ang_step(mi, acc):
            # stacked-table rows 0..15 = modes 2..17 (main ref = LEFT,
            # negative extension gathered from TOP); rows 16.. = vertical
            topside = mi >= 16
            fsel = use_f_ang[mi]
            rt_m = jnp.where(fsel, frt, rt)
            rl_m = jnp.where(fsel, frl, rl)
            co_m = jnp.where(fsel, fco, co)
            mainn = jnp.where(topside, rt_m, rl_m)
            other = jnp.where(topside, rl_m, rt_m)
            negm = jnp.asarray(negc)[mi]
            negc_m = jnp.asarray(neg_is_c)[mi]
            extneg = jnp.where(negc_m[None, :], co_m[:, None],
                               jnp.take(other, negm, axis=1))
            ext = jnp.concatenate(
                [extneg, co_m[:, None], mainn,
                 mainn[:, 2 * n - 1][:, None]], axis=1)
            idx = jnp.asarray(pos_rel)[mi]
            g0 = jnp.take(ext, idx, axis=1)
            g1 = jnp.take(ext, idx + 1, axis=1)
            f = jnp.asarray(fact)[mi]
            pred = ((32 - f) * g0 + f * g1 + 16) >> 5
            return acc.at[:, mi].set(satd1(pred).astype(jnp.int32))

        sang = jax.lax.fori_loop(
            0, 33, ang_step, jnp.zeros((B, 33), jnp.int32))
        out = jnp.concatenate([s0[:, None], s1[:, None], sang], axis=1)
        return out.reshape(hn, wn, 35).astype(jnp.int32)

    import jax
    return jax.jit(program)


def rank_satd_tables_device(plane, zscan, bd, strong,
                            sizes=(4, 8, 16, 32)):
    """Device twin of rank_satd_tables_host: {n: (hn, wn, 35) int32}."""
    plane = np.asarray(plane, np.int16)
    h, w = plane.shape
    out = {}
    for n in sizes:
        if h // n == 0 or w // n == 0:
            continue
        key = ("rank", w, h, n, bd, bool(strong))
        if key not in _JIT_CACHE:
            _JIT_CACHE[key] = _rank_tables_program(w, h, n, bd,
                                                   bool(strong),
                                                   np.asarray(zscan))
        out[n] = np.asarray(_JIT_CACHE[key](plane))
    return out


def install_subpel_fields(enc) -> Optional[dict]:
    """Device-compute the subpel planes of each list's ref-0 plane for
    native install; {(list, 0): (15, ph, pw) int16} or None."""
    if enc.sh.is_i or os.environ.get("TC_NO_SUBPEL_PLANES"):
        return None
    out = {}
    done = {}
    for lx in (0, 1):
        refs = enc.ref_lists[lx] if lx < len(enc.ref_lists) else []
        if not refs:
            continue
        plane = refs[0].planes[0]
        k = id(plane)
        if k not in done:
            done[k] = subpel_planes_device(np.asarray(plane),
                                           enc.sps.bit_depth_y)
        out[(lx, 0)] = done[k]
    return out or None


def install_seed_fields(enc, orig) -> Optional[dict]:
    """Run the device encoder analysis (lowres pre-ME + dense full-pel ME
    field) for the encoder's list-0/1 ref-0 planes and prefill the Python
    caches; returns {list: (seed_mv, dense_mv|None, wb, hb)} for the
    native install, or None when the stage does not apply."""
    if enc.sh.is_i or getattr(enc, "search_range", 0) < 16:
        return None
    want_dense = not os.environ.get("TC_NO_DENSEME")
    fields = {}
    done = {}
    for lx in (0, 1):
        refs = enc.ref_lists[lx] if lx < len(enc.ref_lists) else []
        if not refs:
            continue
        plane = refs[0].planes[0]
        k = id(plane)
        # device SAD surfaces are opt-in (TC_DEV_SURF): the (hb*wb, 289)
        # tensor's pull to the host measured wall-neutral against the
        # probes it serves
        want_surf = want_dense and bool(os.environ.get("TC_DEV_SURF"))
        if k not in done:
            surf = None
            if want_surf:
                sm, dm, ds, wb, hb, surf = analysis_device(
                    np.asarray(orig[0]), np.asarray(plane),
                    want_surf=True)
            elif want_dense:
                sm, dm, ds, wb, hb = analysis_device(np.asarray(orig[0]),
                                                     np.asarray(plane))
            else:
                sm, wb, hb = seed_field_device(np.asarray(orig[0]),
                                               np.asarray(plane))
                dm = ds = None
            done[k] = (sm, dm, ds, wb, hb, surf)
        sm, dm, ds, wb, hb, surf = done[k]
        enc._lr_seed_cache[k] = (sm, wb, hb)
        if dm is not None:
            enc._dense_cache[k] = (dm, ds, wb, hb, surf)
        fields[lx] = (sm, dm, wb, hb, surf)
    return fields or None
