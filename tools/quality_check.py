"""Quick quality/size A-B of the current encoder vs a tweak toggled by env.

Usage: python tools/quality_check.py [n_frames] [qp]
Encodes caminandes (decoded by our decoder) twice — TC_NO_SATDGATE unset
vs set — and prints bytes + PSNR for each.
"""
import os
import sys
import time

for _v in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import numpy as np


def psnr(a, b, maxv=255.0):
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(maxv * maxv / mse)


def run(frames, qp, gop_m=1):
    from turingcodec.decode.decoder import Decoder
    from turingcodec.encode.encoder import EncoderConfig, Encoder
    h, w = frames[0][0].shape
    cfg = EncoderConfig(width=w, height=h, qp=qp,
                        rd_candidates=1, search_range=32,
                        gop_m=gop_m, sao=False, rdoq=True, sdh=True)
    enc = Encoder(cfg)
    out = [enc.headers()]
    t0 = time.time()
    recons = []
    for fr in frames:
        for (_i, nal, rec) in enc.push_frame([p.copy() for p in fr]):
            out.append(nal)
            if rec is not None:
                recons.append(rec)
    for (_i, nal, rec) in enc.flush():
        out.append(nal)
        if rec is not None:
            recons.append(rec)
    dt = time.time() - t0
    bs = b"".join(out)
    # decode our own stream for recon
    dec = Decoder()
    outf = [[np.asarray(p) for p in f.planes] for f in dec.decode_stream(bs)]
    ps = [np.mean([psnr(a[c], b[c]) for c in range(3)])
          for a, b in zip(frames, outf)]
    return len(bs), float(np.mean(ps)), len(frames) / dt


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    qp = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    up = len(sys.argv) > 3 and sys.argv[3] == "1080"
    from turingcodec.decode.decoder import Decoder
    data = open("/root/reference/test/"
                "excerpt_(CC)_caminandes.com_640x360.hevc", "rb").read()
    dec = Decoder()
    frames = []
    for f in dec.decode_stream(data):
        if len(frames) >= n:
            break
        frames.append([np.asarray(p).astype(np.int16) for p in f.planes])
    if up:  # bench.py's deterministic 3x nearest upscale
        frames = [[np.kron(p.astype(np.uint8), np.ones((3, 3), np.uint8))
                   [:1080 if p.shape[0] == 360 else 540,
                    :1920 if p.shape[1] == 640 else 960].astype(np.int16)
                   for p in planes] for planes in frames]
    b1, p1, f1 = run(frames, qp)
    print(f"default      : {b1} bytes  {p1:.4f} dB  {f1:.2f} fps")


if __name__ == "__main__":
    main()
