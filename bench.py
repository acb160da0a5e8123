"""Benchmark entry point: prints ONE JSON line
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Headline metric (BASELINE.json): 1080p low-delay encode frames/s at the
fast preset (RDOQ+SDH on — our fast defaults): QP 30, rd_candidates=1,
search_range=32, GOP M=1, no SAO, 16 frames. Compression at this
operating point against the reference encoder is in QUALITY.md
(reproduce with `python -m turingcodec.tools.bdrate`).

The 1080p input is a deterministic 3x nearest-neighbour upscale of the
caminandes stream decoded by our own decoder; the decode is
md5-asserted against the reference decoder's output first, so this bench
also re-verifies decoder correctness on every run.

vs_baseline = our fps / the reference `turing encode` fps under
identical conditions (1080p, QP30, --speed fast, --max-gop-m 1, 2
threads), measured live on the same input when the reference binary is
present, else a recorded anchor from an earlier host. No speed figure
in this file is current: the benchmark is being rebuilt around seeded
content and the GPU (see ROADMAP.md, Queue 1 #1).
Our encoder uses all host cores (deterministic WPP row threading).
"""
import hashlib
import json
import os
import sys
import time

# must precede the first numpy import: OpenBLAS worker threads spin-wait
# after every numpy call and steal cores from the codec's own WPP threads
for _v in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

CAMINANDES = "/root/reference/test/excerpt_(CC)_caminandes.com_640x360.hevc"
GOLDEN_MD5 = "05c8e88dd7a694829f34ad9486a0dd8e"
REFERENCE_ENC_FPS = 1.34   # recorded round-1 anchor (fallback when the
                           # reference binary is absent on this host)
REF_BIN = "/tmp/turing-dbg/turing/turing"
N_FRAMES = 16
QP = 30


def measure_reference_anchor(ups) -> float:
    """Live same-host anchor: the reference binary on the bench's exact
    16-frame input (median of 2 runs). 0.0 when unavailable."""
    import subprocess
    import numpy as np
    if not os.path.exists(REF_BIN):
        return 0.0
    yuv = "/tmp/bench_anchor.yuv"
    try:
        with open(yuv, "wb") as fh:
            for pl in ups:
                for p in pl:
                    fh.write(p.astype(np.uint8).tobytes())
        fpss = []
        for _ in range(2):
            t0 = time.time()
            r = subprocess.run(
                [REF_BIN, "encode", "--input-res", "1920x1080",
                 "--frames", str(len(ups)), "--frame-rate", "24",
                 "--qp", str(QP), "--speed", "fast", "--max-gop-m", "1",
                 "--threads", "2", "-o", "/tmp/bench_anchor.hevc", yuv],
                capture_output=True, timeout=600)
            if r.returncode != 0:
                return 0.0
            fpss.append(len(ups) / (time.time() - t0))
        return max(fpss)
    except Exception:
        return 0.0


def main():
    import numpy as np

    from turingcodec.utils.device import enable_compile_cache
    enable_compile_cache()

    from turingcodec.decode.decoder import Decoder
    from turingcodec.encode.encoder import EncoderConfig, Encoder
    from turingcodec.encode.encoder import read_yuv_frame  # noqa: F401

    # 1) decode the bundled stream (md5 oracle = decoder correctness)
    data = open(CAMINANDES, "rb").read()
    dec = Decoder()
    md5 = hashlib.md5()
    frames = []
    for f in dec.decode_stream(data):
        planes = [np.asarray(p) for p in f.planes]
        if len(frames) < N_FRAMES:
            frames.append(planes)
        md5.update(np.concatenate(
            [p.astype(np.uint8).ravel() for p in planes]).tobytes())
    decode_ok = md5.hexdigest() == GOLDEN_MD5

    # 2) deterministic 3x upscale to 1080p
    ups = []
    for planes in frames:
        ups.append([np.kron(p.astype(np.uint8), np.ones((3, 3), np.uint8))
                    [:1080 if p.shape[0] == 360 else 540,
                     :1920 if p.shape[1] == 640 else 960].astype(np.int16)
                    for p in planes])

    # 3) encode (fast preset defaults: RDOQ+SDH on, no SAO, GPB low delay)
    def run():
        cfg = EncoderConfig(width=1920, height=1080, qp=QP,
                            rd_candidates=1, search_range=32,
                            gop_m=1, sao=False, rdoq=True, sdh=True)
        enc = Encoder(cfg)
        out = [enc.headers()]
        t0 = time.time()
        for fr in ups:
            for (_idx, nal, _recon) in enc.push_frame(
                    [p.copy() for p in fr]):
                out.append(nal)
        for (_idx, nal, _recon) in enc.flush():
            out.append(nal)
        dt = time.time() - t0
        return len(ups) / dt, b"".join(out)

    fps1, bs = run()
    fps2, _ = run()   # best of 3: host timing is noisy
    fps3, _ = run()
    fps = max(fps1, fps2, fps3)

    # sanity: our own decoder must reproduce the encoder's recon hashes
    dec2 = Decoder()
    n_dec = sum(1 for _ in dec2.decode_stream(bs))
    encode_ok = n_dec == len(ups) and dec2.hash_failures == 0

    ok = decode_ok and encode_ok
    anchor = measure_reference_anchor(ups)
    if anchor > 0:
        print(f"live same-host reference anchor: {anchor:.3f} fps",
              file=sys.stderr)
    else:
        anchor = REFERENCE_ENC_FPS
        print(f"reference binary absent: recorded round-1 anchor "
              f"{anchor} fps", file=sys.stderr)
    print(json.dumps({
        "metric": "encode_fps_1080p_fast"
                  + ("" if ok else "_NOT_VERIFIED"),
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / anchor, 4),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
