"""Smoke test of the codec's device stages on one GPU.

Drives the main path once, through the entry points a user calls
(`Encoder.push_frame`/`flush`, `Decoder.decode_stream`), at 1920x1080, in
one process and in phases:

0. Environment: JAX must find a GPU (there is no CPU fallback) and the
   native core must load. Prints the card, the versions and set-up times.
1. Parity at real widths, bit-exact: the ops/ kernels at 8160 blocks (a
   1080p picture's 16x16 blocks) against their numpy oracles; the encoder
   analysis (seed field, dense field and SADs, subpel planes, rank-SATD
   tables) against its host twins; the device deblock and SAO against the
   host filters on a 1080p picture.
2. Encode of seeded 1080p content: low-delay fast (8 frames) and random
   access GOP 8 with SAO (9 frames), each with the device stages on (cold,
   then warm) and off. The bitstreams must be identical.
3. Decode of both streams with the device pipeline (twice) and without:
   md5s equal, no hash SEI failure, no picture left to the host. Then every
   stream in tests/streams against tests/streams/GOLDEN.json, with exactly
   the host pictures listed in HOST_PICTURES.

Timings are printed for information; nothing is gated on them. The last
line of stdout is {"ok": true, "device": {...}}, printed only when every
phase passed; any failure exits non-zero.

Usage: python chip_smoke.py [--profile DIR]
  --profile DIR  instead of the phases: trace one warm 1080p low-delay
                 encode into DIR with jax.profiler, print the device time
                 of each jitted program and the device busy time, and
                 time the dense ME stage alone (no "ok" line).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

# first: the package pins BLAS threads before numpy loads (and a copy of
# this script outside the repository stops here)
from turingcodec.utils.device import enable_compile_cache

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
BLOCKS_1080P = (W // 16) * (-(-H // 16))   # 8160 16x16 blocks

# the repo's 1080p low-delay fast workload, and random access GOP 8 + SAO
LDP_FAST = dict(qp=30, rd_candidates=1, search_range=32, gop_m=1,
                sao=False, rdoq=True, sdh=True)
RA_SAO = dict(qp=30, rd_candidates=1, search_range=32, gop_m=8,
              sao=True, rdoq=True, sdh=True)


# Pictures of tests/streams that the device pipeline leaves to the host,
# by reason: it has no weighted prediction, and these streams use it.
HOST_PICTURES = {
    "vfy_wp.hevc": {"weighted prediction": 3},
    "wpc_test.hevc": {"weighted prediction": 3},
}


class CheckFailed(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- content

def _smooth_noise(rng, h, w, cell):
    """Value noise: a coarse random grid upsampled bilinearly."""
    gh, gw = h // cell + 2, w // cell + 2
    g = rng.random((gh, gw))
    y = np.arange(h) / cell
    x = np.arange(w) / cell
    y0, x0 = y.astype(int), x.astype(int)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def make_frames(w, h, n, seed=0, pan=(4, 2), obj_step=(-6, 4)):
    """Seeded 8-bit 4:2:0 frames [y, cb, cr] (int16): a textured
    background panned by `pan` (dx, dy) luma samples per frame, a textured
    square moving by `obj_step`, and mild grain."""
    rng = np.random.default_rng(seed)
    px, py = pan
    bw, bh = w + n * abs(px) + 16, h + n * abs(py) + 16
    yy, xx = np.mgrid[0:bh, 0:bw]
    bg = (120 * _smooth_noise(rng, bh, bw, 32)
          + 40 * _smooth_noise(rng, bh, bw, 6)
          + 25 * np.sin(xx / 7.0) * np.cos(yy / 11.0) + 40)
    bgc = [70 * _smooth_noise(rng, bh // 2, bw // 2, 24) + 93
           for _ in range(2)]
    s = max(8, (min(w, h) // 6) & ~7)
    oy, ox = np.mgrid[0:s, 0:s]
    obj = 60 + 120 * (((oy // 4 + ox // 4) % 2)) + 40 * ox / s
    frames = []
    for i in range(n):
        x0 = 8 + (i * px if px >= 0 else (n - i) * -px)
        y0 = 8 + (i * py if py >= 0 else (n - i) * -py)
        luma = bg[y0:y0 + h, x0:x0 + w].copy()
        cx = (w // 3 + i * obj_step[0]) % max(1, w - s)
        cy = (h // 3 + i * obj_step[1]) % max(1, h - s)
        luma[cy:cy + s, cx:cx + s] = obj
        luma += rng.normal(0, 1.5, luma.shape)
        planes = [np.clip(np.rint(luma), 0, 255).astype(np.int16)]
        for c in bgc:
            ch = c[y0 // 2:y0 // 2 + h // 2, x0 // 2:x0 // 2 + w // 2]
            planes.append(np.clip(np.rint(ch), 0, 255).astype(np.int16))
        frames.append(planes)
    return frames


# ---------------------------------------------------------------- helpers

class CompileCounter:
    """Counts the XLA programs built (compiled, or loaded from the
    persistent compile cache: JAX times both as one event), their seconds,
    and how many of them came from the cache."""

    def __init__(self):
        import jax.monitoring
        self.n = 0
        self.seconds = 0.0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)
        jax.monitoring.register_event_listener(self._on_event)

    def _on(self, event, duration, **_kw):
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1
            self.seconds += duration

    def _on_event(self, event, **_kw):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def snapshot(self):
        return self.n, self.seconds

    def describe(self):
        return (f"{self.n} programs built ({self.n - self.cache_hits} "
                f"compiled, {self.cache_hits} loaded from the compile "
                f"cache), {self.seconds:.1f} s")


def peak_device_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def encode(frames, w, h, device, **cfg):
    from turingcodec.encode.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(width=w, height=h, device=device, **cfg))
    check(enc.device == device, "encoder did not take the device choice")
    out = [enc.headers()]
    for f in frames:
        out += [nal for (_i, nal, _r) in enc.push_frame(
            [p.copy() for p in f])]
    out += [nal for (_i, nal, _r) in enc.flush()]
    return b"".join(out)


def decode(data, device):
    """-> (md5 of the output frames, frames, hash failures, {reason:
    pictures} the device pipeline left to the host)."""
    from turingcodec.decode.decoder import Decoder
    dec = Decoder(device=device)
    md5 = hashlib.md5()
    n = 0
    for frame in dec.decode_stream(data):
        for plane in frame.planes:
            md5.update(np.asarray(plane).astype(np.uint8).tobytes())
        n += 1
    return md5.hexdigest(), n, dec.hash_failures, dict(dec.device_fallbacks)


# ---------------------------------------------------------------- phases

def phase0_environment():
    """GPU or nothing; then the card, versions and native build."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX backend is {backend!r}, not 'gpu': this "
              "check runs on the GPU only", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    import jaxlib
    dev = jax.devices()[0]
    log(f"[0] card: {smi}")
    log(f"[0] jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"device_kind {dev.device_kind!r}, devices {len(jax.devices())}, "
        f"host CPUs {os.cpu_count()}")
    cache = enable_compile_cache()
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"[0] compile cache {cache}: {n_cached} entries at start")
    from turingcodec import native
    t0 = time.perf_counter()
    lib = native.get_lib()
    check(lib is not None, "native core did not load")
    log(f"[0] native core: {os.path.basename(native.so_path)}, build "
        f"{native.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s")
    return smi, dev


def phase1_kernels(batch, iters=3):
    from turingcodec.tools.kernels import check_kernels
    rows = check_kernels(batch, iters)
    for name, ok, t, work, unit in rows:
        log(f"[1] {name:<22} {'ok' if ok else 'MISMATCH'} "
            f"{t * 1e3:9.3f} ms/call at {batch} blocks")
    bad = [r[0] for r in rows if not r[1]]
    check(not bad, f"kernels differ from their oracles: {bad}")


def phase1_analysis(orig, ref, geom_zscan, bit_depth=8):
    """Encoder analysis on device vs its host twins at the picture size."""
    from turingcodec import native
    from turingcodec.encode import device_analysis as da
    from turingcodec.encode.inter_search import InterPictureEncoder
    host = InterPictureEncoder.__new__(InterPictureEncoder)
    host._lr_seed_cache, host._dense_cache = {}, {}
    host.orig = [orig]

    t0 = time.perf_counter()
    sm, wb, hb = da.seed_field_device(orig, ref)
    sm_h, wb_h, hb_h = host._lowres_seed_field(ref)
    check((wb, hb) == (wb_h, hb_h) and np.array_equal(sm, sm_h),
          "device seed field != host twin")

    sm2, dm, ds, _, _ = da.analysis_device(orig, ref)
    dm_h, ds_h, _, _ = host._dense_field(ref)
    check(np.array_equal(sm2, sm_h), "fused analysis seeds != host twin")
    check(np.array_equal(dm, dm_h), "device dense field != host twin")
    check(np.array_equal(ds, ds_h), "device dense SADs != host twin")
    nat = native.dense_analysis(orig, ref, 8)
    check(nat is not None and np.array_equal(nat[1], dm_h)
          and np.array_equal(nat[2], ds_h), "native dense field != host")

    sp = da.subpel_planes_device(ref, bit_depth)
    check(np.array_equal(sp, da.subpel_planes_host(ref, bit_depth)),
          "device subpel planes != host twin")

    rk = da.rank_satd_tables_device(orig, geom_zscan, bit_depth, True)
    rk_h = da.rank_satd_tables_host(orig, geom_zscan, bit_depth, True)
    check(sorted(rk) == sorted(rk_h) == [4, 8, 16, 32]
          and all(np.array_equal(rk[n], rk_h[n]) for n in rk_h),
          "device rank-SATD tables != host twin")
    log(f"[1] encoder analysis at {orig.shape[1]}x{orig.shape[0]}: seed "
        f"field {hb}x{wb}, dense field + SADs, 15 subpel planes, rank-SATD "
        f"4..32 all exact ({time.perf_counter() - t0:.1f} s with oracles)")


def phase1_loop_filters(frames, w, h):
    """Device deblock and SAO vs the host filters on decoded pictures of
    a random access GOP 8 + SAO stream."""
    from turingcodec.decode.deblock_vec import deblock_picture_vec
    from turingcodec.decode.decoder import Decoder
    from turingcodec.decode.picture_recon import PictureReconstructor
    from turingcodec.decode.sao import sao_picture
    from turingcodec.ops.deblock import deblock_picture_device
    from turingcodec.ops.sao import sao_picture_device
    caught = []

    class Capture(PictureReconstructor):
        def _loop_filters(self):
            caught.append((self.plan, self.geom,
                           [p.copy() for p in (self.ry, self.rcb,
                                               self.rcr)]))
            return super()._loop_filters()

    data = encode(frames[:3], w, h, False, **RA_SAO)
    dec = Decoder(reconstructor_cls=Capture, device=False)
    n_out = sum(1 for _ in dec.decode_stream(data))
    check(n_out == 3 and len(caught) == 3, "loop-filter stream decode")
    n_sao = 0
    for plan, geom, pre in caught:
        host = [p.copy() for p in pre]
        deblock_picture_vec(plan, geom, *host)
        dev = [p.copy() for p in pre]
        deblock_picture_device(plan, geom, *dev)
        check(all(np.array_equal(a, b) for a, b in zip(dev, host)),
              "device deblock != host filter")
        if any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
               for sh in plan.slice_headers):
            n_sao += 1
            want = sao_picture(plan, geom, [p.copy() for p in host])
            got = sao_picture_device(plan, geom, [p.copy() for p in host])
            check(all(np.array_equal(np.asarray(a), np.asarray(b))
                      for a, b in zip(got, want)), "device SAO != host")
    check(n_sao > 0, "no picture of the loop-filter stream used SAO")
    log(f"[1] deblock on {len(caught)} pictures and SAO on {n_sao} at "
        f"{w}x{h}: exact")


def phase2_encode(name, frames, w, h, cfg, counter):
    """Device on (cold, then warm) and off; bitstreams must match."""
    t0 = time.perf_counter()
    c0 = counter.snapshot()
    cold = encode(frames, w, h, True, **cfg)
    t_cold = time.perf_counter() - t0
    c1 = counter.snapshot()
    t0 = time.perf_counter()
    warm = encode(frames, w, h, True, **cfg)
    t_warm = time.perf_counter() - t0
    c2 = counter.snapshot()
    t0 = time.perf_counter()
    off = encode(frames, w, h, False, **cfg)
    t_off = time.perf_counter() - t0
    check(cold == warm == off,
          f"{name}: bitstreams differ between device on and off")
    n = len(frames)
    log(f"[2] {name}: {n} frames {w}x{h}, {len(warm)} bytes, identical "
        f"on/off; warm device-on {n / t_warm:.3f} frames/s, device-off "
        f"{n / t_off:.3f} frames/s; cold first encode {t_cold:.1f} s with "
        f"{c1[0] - c0[0]} programs built ({c1[1] - c0[1]:.1f} s); "
        f"{c2[0] - c1[0]} programs built in the warm encode; peak device "
        f"memory {peak_device_bytes()} bytes")
    return warm


def phase3_decode(name, data, n_frames, counter):
    t0 = time.perf_counter()
    on1 = decode(data, True)
    t1 = time.perf_counter()
    c1 = counter.snapshot()
    on2 = decode(data, True)
    t2 = time.perf_counter()
    c2 = counter.snapshot()
    off = decode(data, False)
    t3 = time.perf_counter()
    for label, r in (("device run 1", on1), ("device run 2", on2),
                     ("host", off)):
        check(r[1] == n_frames, f"{name}: {label} gave {r[1]} frames")
        check(r[2] == 0, f"{name}: {label} had {r[2]} hash SEI failures")
    check(on1[3] == on2[3] == {},
          f"{name}: pictures fell back to the host: {on1[3]}")
    check(on1[0] == on2[0] == off[0],
          f"{name}: decoded md5 differs across runs or device on/off")
    log(f"[3] {name}: md5 {on1[0]} on device (twice) and host, 0 hash "
        f"failures, 0 host fallbacks; device decode {t1 - t0:.1f} s cold, "
        f"{t2 - t1:.1f} s warm ({n_frames / (t2 - t1):.2f} frames/s, "
        f"{c2[0] - c1[0]} programs built), host {t3 - t2:.1f} s "
        f"({n_frames / (t3 - t2):.2f} frames/s)")


def phase3_golden():
    d = os.path.join(HERE, "tests", "streams")
    with open(os.path.join(d, "GOLDEN.json")) as fh:
        golden = {k: v for k, v in json.load(fh).items()
                  if not k.startswith("_")}
    for stream, want in sorted(golden.items()):
        with open(os.path.join(d, stream), "rb") as fh:
            md5, n, fails, fallbacks = decode(fh.read(), True)
        check(md5 == want and fails == 0,
              f"{stream}: md5 {md5} != golden {want} or {fails} hash fails")
        expected = HOST_PICTURES.get(stream, {})
        check(fallbacks == expected, f"{stream}: pictures on the host "
              f"{fallbacks}, expected {expected}")
        log(f"[3] {stream}: {n} frames match GOLDEN.json"
            + (f" (host pictures as expected: {fallbacks})"
               if fallbacks else ""))


# ---------------------------------------------------------------- profile

def device_times(trace_dir, plane_tag="GPU"):
    """Reduce a jax.profiler trace to (device ns per XLA program
    {module: [kernels, ns]}, device busy ns, first-to-last kernel ns,
    {plane: [line names]}). Kernels are the events that carry an
    `hlo_module` stat on the planes whose name holds `plane_tag`; busy
    time is the union of their intervals."""
    import glob
    from jax.profiler import ProfileData
    per, spans, layout = {}, [], {}
    for path in glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                       "*", "*.xplane.pb")):
        for plane in ProfileData.from_file(path).planes:
            if plane_tag not in plane.name:
                continue
            layout[plane.name] = [line.name for line in plane.lines]
            for line in plane.lines:
                for ev in line.events:
                    module = dict(ev.stats).get("hlo_module")
                    if module is None:
                        continue
                    ent = per.setdefault(str(module), [0, 0.0])
                    ent[0] += 1
                    ent[1] += ev.duration_ns
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _a, b in spans) - min(a for a, _b in spans)
              if spans else 0.0)
    return per, busy, window, layout


def profile(trace_dir):
    """Trace one warm device-on low-delay encode at 1080p and time the
    dense ME stage alone, seeded as in production."""
    import jax
    import jax.numpy as jnp
    from turingcodec.encode import device_analysis as da
    frames = make_frames(W, H, 8, seed=1)
    encode(frames, W, H, True, **LDP_FAST)   # compile every program
    orig, ref = frames[1][0], frames[0][0]
    seeds, wb, hb = da.seed_field_device(orig, ref)

    def dense_only(o, r, s):
        return da._dense_stage(o, r, s, W, H, wb, hb)

    dense = jax.jit(dense_only)
    args = (jnp.asarray(orig), jnp.asarray(ref), jnp.asarray(seeds))
    jax.block_until_ready(dense(*args))
    t0 = time.perf_counter()
    for _ in range(20):
        jax.block_until_ready(dense(*args))
    dense_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        da.analysis_device(orig, ref)
    analysis_ms = (time.perf_counter() - t0) / 20 * 1e3
    log(f"[p] host clock, 20 warm calls at {W}x{H}: dense stage alone "
        f"{dense_ms:.3f} ms, seed + dense analysis with its host "
        f"transfers {analysis_ms:.3f} ms per reference plane")

    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        encode(frames, W, H, True, **LDP_FAST)
        wall = time.perf_counter() - t0
        for _ in range(5):
            jax.block_until_ready(dense(*args))
    per, busy, window, layout = device_times(trace_dir)
    for plane, lines in sorted(layout.items()):
        log(f"[p] trace plane {plane}: lines {lines[:8]}")
    log(f"[p] traced warm LDP encode of {len(frames)} frames: wall "
        f"{wall:.3f} s; device busy {busy / 1e9:.4f} s over a "
        f"{window / 1e9:.3f} s kernel window (encode + 5 dense calls)")
    for name, (calls, ns) in sorted(per.items(), key=lambda kv: -kv[1][1]):
        log(f"[p]   {name:<44} {calls:6d} kernels {ns / 1e6:10.3f} ms")


# ---------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args(argv)

    smi, dev = phase0_environment()
    if args.profile:
        profile(args.profile)
        return 0
    counter = CompileCounter()
    import jax

    t0 = time.perf_counter()
    phase1_kernels(BLOCKS_1080P)
    frames = make_frames(W, H, 9, seed=1)
    from turingcodec.encode.encoder import Encoder, EncoderConfig
    zscan = Encoder(EncoderConfig(width=W, height=H, device=True)).geom.zscan
    phase1_analysis(frames[1][0], frames[0][0], zscan)
    phase1_loop_filters(frames, W, H)
    log(f"[1] done in {time.perf_counter() - t0:.1f} s; "
        f"{counter.describe()} so far")

    ldp = phase2_encode("LDP fast", frames[:8], W, H, LDP_FAST, counter)
    ra = phase2_encode("RA GOP8 SAO", frames[:9], W, H, RA_SAO, counter)
    phase3_decode("LDP fast", ldp, 8, counter)
    phase3_decode("RA GOP8 SAO", ra, 9, counter)
    phase3_golden()

    log(f"set-up: {counter.describe()} in all; "
        f"peak device memory {peak_device_bytes()} bytes")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
