"""Phase-profile the 1080p fast encode (bench.py's workload).

Usage:  TURING_NATIVE_PROF=1 python tools/profile_encode.py [n_frames]

Runs the same deterministic 3x-upscaled caminandes workload as bench.py,
single-threaded for clean attribution (override TURING_ENC_THREADS),
and prints the native enc_core phase counters as seconds/frame.

Phase slots (enc_core.cpp g_enc_ns): nested timers overlap — inter_cu
includes full_pel/subpel/..., so percentages don't sum to 100.
"""
import hashlib
import json
import os
import sys
import time

os.environ.setdefault("TURING_NATIVE_PROF", "1")
os.environ.setdefault("TURING_ENC_THREADS", "1")
for _v in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import ctypes

import numpy as np

PHASES = [
    "inter_cu", "smp", "intra_cu", "snap", "full_pel", "subpel",
    "fwd_xform", "quantize", "rate_est", "pred_full", "pred_luma",
    "sad16", "rank_modes", "intra_nxn", "try_tb", "lowres+half",
]
COUNTS = ["fp_searches", "sad_single", "sad_batched", "met_stops",
          "batch_puts", "c21ns", "c22", "c23"]
# extra phase slots 24..31 (g_enc_ns[24..31])
XPHASES = ["dense_me", "analysis", "subpel_planes", "deblock", "x28",
           "x29", "x30", "x31"]


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    from turingcodec.decode.decoder import Decoder
    from turingcodec.encode.encoder import EncoderConfig, Encoder
    from turingcodec.native import get_lib

    data = open("/root/reference/test/"
                "excerpt_(CC)_caminandes.com_640x360.hevc", "rb").read()
    dec = Decoder()
    frames = []
    for f in dec.decode_stream(data):
        if len(frames) >= n_frames:
            break
        frames.append([np.asarray(p) for p in f.planes])
    ups = []
    for planes in frames:
        ups.append([np.kron(p.astype(np.uint8), np.ones((3, 3), np.uint8))
                    [:1080 if p.shape[0] == 360 else 540,
                     :1920 if p.shape[1] == 640 else 960].astype(np.int16)
                    for p in planes])

    lib = get_lib()
    lib.tc_enc_counters.argtypes = [ctypes.c_void_p]
    cnt = np.zeros(32, np.int64)
    lib.tc_enc_counters(cnt.ctypes.data)  # reset

    cfg = EncoderConfig(width=1920, height=1080, qp=30,
                        rd_candidates=1, search_range=32,
                        gop_m=1, sao=False, rdoq=True, sdh=True)
    enc = Encoder(cfg)
    out = [enc.headers()]
    t0 = time.time()
    for fr in ups:
        for (_i, nal, _r) in enc.push_frame([p.copy() for p in fr]):
            out.append(nal)
    for (_i, nal, _r) in enc.flush():
        out.append(nal)
    dt = time.time() - t0

    lib.tc_enc_counters(cnt.ctypes.data)
    print(f"total {dt:.2f}s  {len(ups) / dt:.3f} fps "
          f"({dt / len(ups):.3f} s/frame, threads="
          f"{os.environ['TURING_ENC_THREADS']})")
    rows = sorted(list(zip(PHASES, cnt[:16])) + list(zip(XPHASES, cnt[24:])),
                  key=lambda kv: -kv[1])
    for name, ns in rows:
        if ns:
            print(f"  {name:12s} {ns / 1e9 / len(ups):8.4f} s/frame "
                  f"{ns / 1e9 / dt * 100:5.1f}%")
    print("  counts: " + json.dumps(
        {k: int(v) for k, v in zip(COUNTS, cnt[16:24]) if v}))
    # device-twin-covered fraction: stages with proven integer-exact XLA
    # twins (chip_smoke.py phase 1, byte-identical bitstreams with
    # EncoderConfig(device=True)):
    #   [15/24/25] lowres pre-ME + dense ME field (+ facade analysis)
    #   [26] subpel plane builds (device_analysis.subpel_planes_device)
    #   [12] rank_modes — the source-referenced 35-mode SATD ranking of
    #        the MET presets (device_analysis.rank_satd_tables_device);
    #        this workload runs rd_candidates=1, so src-rank is active
    #   [27] loop-filter deblock (native tc_deblock; bit-exact device
    #        twin TURING_DEVICE_DEBLOCK, tests/test_device_deblock)
    dev = (cnt[12] + cnt[15] + cnt[24] + cnt[25] + cnt[26]
           + cnt[27]) / 1e9
    print(f"  device-twin-covered stages: {dev / len(ups):.4f} s/frame "
          f"({dev / dt * 100:.1f}% of wall)")


if __name__ == "__main__":
    sys.exit(main())
