"""BD-rate harness: our encoder vs the reference `turing` encoder.

Runs 4 QP points (26/30/34/38) over several sequences and operating
points (fast low-delay, fast/slow random-access GOP8), computes
Bjontegaard delta-rate from luma PSNR, and writes QUALITY.md.

Usage:
    python -m turingcodec.tools.bdrate [--quick] [--out QUALITY.md]

Reference binary: /tmp/turing-dbg/turing/turing (build recipe in
.claude/skills/verify/SKILL.md). Reference operating points per
turing/encode.cpp:92-153 and Speed.h (fast: no rdoq/sdh/sao, SMP at 8x8,
half-pel; slow: rdoq+sdh+sao, AMP off, RQT, quarter-pel).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

for _v in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import numpy as np

REF_BIN = "/tmp/turing-dbg/turing/turing"
CAMINANDES = ("/root/reference/test/"
              "excerpt_(CC)_caminandes.com_640x360.hevc")
QPS = (26, 30, 34, 38)


def psnr_y(a, b):
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 * 255.0 / mse)


def bd_rate(r_ref, p_ref, r_test, p_test):
    """Piecewise-linear Bjontegaard delta-rate (%) of test vs ref."""
    lo = max(min(p_ref), min(p_test))
    hi = min(max(p_ref), max(p_test))
    xs = np.linspace(lo, hi, 256)
    lr = np.interp(xs, p_ref, np.log(np.asarray(r_ref, np.float64)))
    lt = np.interp(xs, p_test, np.log(np.asarray(r_test, np.float64)))
    return float((np.exp(np.mean(lt - lr)) - 1.0) * 100.0)


def load_sequences(quick):
    from turingcodec.decode.decoder import Decoder
    data = open(CAMINANDES, "rb").read()
    dec = Decoder()
    frames = []
    n_nat = 16 if quick else 24
    for f in dec.decode_stream(data):
        frames.append([np.asarray(p).astype(np.int16) for p in f.planes])
        if len(frames) >= max(n_nat, 8):
            break
    seqs = {"caminandes-640x360": frames[:n_nat]}
    # deterministic 3x nearest-neighbour 1080p upscale (bench.py workload)
    ups = []
    for planes in frames[:4 if quick else 8]:
        ups.append([np.kron(p.astype(np.uint8), np.ones((3, 3), np.uint8))
                    [:1080 if p.shape[0] == 360 else 540,
                     :1920 if p.shape[1] == 640 else 960].astype(np.int16)
                    for p in planes])
    seqs["caminandes-1080p-3x"] = ups
    # synthetic: moving gradient + deterministic noise (no natural bias)
    rng = np.random.RandomState(42)
    w, h = 320, 192
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.int16)
    # static texture layer keeps the motion-compensated residual nonzero
    # at every QP (otherwise rates collapse to header-only streams and
    # BD percentages become meaningless)
    tex = rng.randint(-24, 25, (h, w)).astype(np.int16)
    noise = rng.randint(-8, 9, (h + 16, w + 16)).astype(np.int16)
    syn = []
    for i in range(8 if quick else 16):
        y = np.clip(np.roll(base + tex, i * 2, 1)
                    + noise[i:i + h, i:i + w], 0, 255).astype(np.int16)
        syn.append([y, np.full((h // 2, w // 2), 128, np.int16),
                    np.full((h // 2, w // 2), 128, np.int16)])
    seqs["synthetic-320x192"] = syn
    return seqs


def write_yuv(frames, path):
    with open(path, "wb") as f:
        for planes in frames:
            for p in planes:
                f.write(np.asarray(p).astype(np.uint8).tobytes())


def run_ours(frames, qp, preset, gop_m):
    from turingcodec.encode.encoder import EncoderConfig, Encoder
    h, w = frames[0][0].shape
    # hash_type=None: the reference emits no decoded-picture-hash SEI, so
    # ours must not either (its ~54 B/frame would skew low-rate points)
    if preset == "fast":
        cfg = EncoderConfig(width=w, height=h, qp=qp, rd_candidates=1,
                            search_range=32, gop_m=gop_m, sao=False,
                            rdoq=True, sdh=True, hash_type=None)
    else:  # slow
        cfg = EncoderConfig(width=w, height=h, qp=qp, rd_candidates=3,
                            search_range=64, gop_m=gop_m, sao=True,
                            rdoq=True, sdh=True, hash_type=None)
    enc = Encoder(cfg)
    nals = [enc.headers()]
    recs = {}
    t0 = time.time()
    for fr in frames:
        for (i, nal, rec) in enc.push_frame([p.copy() for p in fr]):
            nals.append(nal)
            recs[i] = rec
    for (i, nal, rec) in enc.flush():
        nals.append(nal)
        recs[i] = rec
    dt = time.time() - t0
    bs = b"".join(nals)
    ps = float(np.mean([psnr_y(np.asarray(recs[i][0]), frames[i][0])
                        for i in range(len(frames))]))
    return len(bs), ps, len(frames) / dt


def run_reference(yuv_path, w, h, n, qp, preset, gop_m, tag):
    out = f"/tmp/bd_ref_{tag}.hevc"
    rec = f"/tmp/bd_ref_{tag}.yuv"
    cmd = [REF_BIN, "encode", "--input-res", f"{w}x{h}",
           "--frames", str(n), "--frame-rate", "24", "--qp", str(qp),
           "--speed", preset, "--max-gop-m", str(gop_m),
           "--threads", "2", "--dump-frames", rec, "-o", out, yuv_path]
    t0 = time.time()
    subprocess.run(cmd, check=True, capture_output=True)
    dt = time.time() - t0
    fsz = w * h * 3 // 2
    src = np.fromfile(yuv_path, np.uint8)[:n * fsz]
    dec = np.fromfile(rec, np.uint8)[:n * fsz]
    ps = float(np.mean([
        psnr_y(src[i * fsz:i * fsz + w * h], dec[i * fsz:i * fsz + w * h])
        for i in range(n)]))
    return os.path.getsize(out), ps, n / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="QUALITY.md")
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", default=None,
                    help="substring filter on sequence names "
                         "(partial re-measurement; merge by hand)")
    args = ap.parse_args()

    seqs = load_sequences(args.quick)
    if args.only:
        seqs = {k: v for k, v in seqs.items() if args.only in k}
    points = [("fast", 1, "fast-LDP (max-gop-m 1)"),
              ("fast", 8, "fast-RA (max-gop-m 8)"),
              ("slow", 8, "slow-RA (max-gop-m 8)")]
    results = {}
    for sname, frames in seqs.items():
        h, w = frames[0][0].shape
        n = len(frames)
        yuv = f"/tmp/bd_{sname}.yuv"
        write_yuv(frames, yuv)
        for preset, gop_m, label in points:
            key = f"{sname}/{label}"
            ours_r, ours_p, ref_r, ref_p = [], [], [], []
            ofps = rfps = 0.0
            for qp in QPS:
                b, p, f = run_ours(frames, qp, preset, gop_m)
                ours_r.append(b)
                ours_p.append(p)
                ofps += f / len(QPS)
                b, p, f = run_reference(yuv, w, h, n, qp, preset, gop_m,
                                        f"{sname}_{preset}{gop_m}_{qp}")
                ref_r.append(b)
                ref_p.append(p)
                rfps += f / len(QPS)
                print(f"{key} qp{qp}: ours {ours_r[-1]}B {ours_p[-1]:.3f}dB"
                      f" | ref {ref_r[-1]}B {ref_p[-1]:.3f}dB", flush=True)
            bd = bd_rate(ref_r[::-1], ref_p[::-1],
                         ours_r[::-1], ours_p[::-1])
            results[key] = {
                "bd_rate_pct": round(bd, 2),
                "ours": {"bytes": ours_r, "psnr_y": ours_p,
                         "fps": round(ofps, 2)},
                "reference": {"bytes": ref_r, "psnr_y": ref_p,
                              "fps": round(rfps, 2)},
            }
            print(f"== {key}: BD-rate {bd:+.2f}% "
                  f"(speed {ofps / max(rfps, 1e-9):.2f}x)", flush=True)

    lines = [
        "# QUALITY — BD-rate vs the reference encoder",
        "",
        "Reproduce: `python -m turingcodec.tools.bdrate"
        + (" --quick" if args.quick else "") + "`",
        "(reference binary per .claude/skills/verify/SKILL.md; "
        "4 QP points 26/30/34/38, piecewise-linear BD on luma PSNR; "
        "negative BD-rate = we need fewer bits at equal PSNR).",
        "",
        "| sequence / operating point | BD-rate | our fps | ref fps |",
        "|---|---|---|---|",
    ]
    for key, r in results.items():
        lines.append(
            f"| {key} | {r['bd_rate_pct']:+.2f}% | {r['ours']['fps']} "
            f"| {r['reference']['fps']} |")
    lines.append("")
    lines.append("Raw points (bytes @ PSNR-Y per QP 26/30/34/38):")
    lines.append("```json")
    lines.append(json.dumps(results, indent=1))
    lines.append("```")
    open(args.out, "w").write("\n".join(lines) + "\n")
    if args.json:
        open(args.json, "w").write(json.dumps(results))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
