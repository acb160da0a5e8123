"""CLI: golden-hash regression over encode/decode round trips
(turing signature analogue, turing/signature.cpp:193-281).

Decodes the bundled caminandes stream (md5-checked), re-encodes the first
frames under the configuration matrix and checks 4-byte md5 prefixes of
both the bitstream and the reconstruction against the pinned goldens,
asserting encoder-recon == decoder-recon throughout. Like the reference's
asm0/threads-1 rows (signature.cpp:228-237), the threads-1 and
native-off rows share the default row's goldens: output is deterministic
across thread count and across the native/Python twins.

Run with --update to print (and accept) freshly measured hashes.
"""
from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

STREAM = "/root/reference/test/excerpt_(CC)_caminandes.com_640x360.hevc"
DECODE_MD5 = "05c8e88dd7a694829f34ad9486a0dd8e"

# (name, config overrides, n_frames, env overrides, golden (bits4, recon4)).
# Goldens pinned from the current encoder; any decision drift fails here
# first. The determinism rows reference another row's goldens by name.
CONFIGS = [
    ("all-intra-q32", dict(all_intra=True, qp=32, rd_candidates=2), 2,
     {}, ("2bd67113", "5d6fe9e0")),
    ("lowdelay-q32", dict(qp=32, rd_candidates=2), 3,
     {}, ("ecfe6823", "5c692f97")),
    ("lowdelay-q32-threads1", dict(qp=32, rd_candidates=2), 3,
     {"TURING_ENC_THREADS": "1"}, "lowdelay-q32"),
    ("lowdelay-q32-no-native", dict(qp=32, rd_candidates=2), 3,
     {"TURING_NO_NATIVE": "1"}, "lowdelay-q32"),
    ("gop4-q32", dict(qp=32, rd_candidates=2, gop_m=4), 5,
     {}, ("54e1595d", "bca186e4")),
    # frame-parallel determinism: one-picture-at-a-time must reproduce
    # the default (2 in-flight pictures) exactly — the reference's
    # concurrent-frames invariant
    ("gop4-q32-frame-seq", dict(qp=32, rd_candidates=2, gop_m=4), 5,
     {"TURING_FRAME_THREADS": "1"}, "gop4-q32"),
    # inter-picture overlap (frame_overlap): its own deterministic
    # operating point (MV y-clamp + source-referenced analysis); pinned
    # goldens + byte-identity at 1 and 4 in-flight pictures — the
    # wavefront's waits and the follower's band timing never change a bit
    ("overlap-q32", dict(qp=32, rd_candidates=2, sao=False,
                         frame_overlap=True), 5,
     {}, ("428353ec", "80ed9a50")),
    ("overlap-q32-seq", dict(qp=32, rd_candidates=2, sao=False,
                             frame_overlap=True),
     5, {"TURING_FRAME_THREADS": "1"}, "overlap-q32"),
    ("overlap-q32-ft4", dict(qp=32, rd_candidates=2, sao=False,
                             frame_overlap=True),
     5, {"TURING_FRAME_THREADS": "4"}, "overlap-q32"),
    # SAO under overlap: the follower's banded estimate+apply (one CTB
    # row behind the deblock band) must equal the raster walk at any
    # in-flight count
    ("overlap-sao-q32", dict(qp=32, rd_candidates=2, sao=True,
                             frame_overlap=True), 5,
     {}, ("6bd32278", "f0fe46cd")),
    ("overlap-sao-q32-seq", dict(qp=32, rd_candidates=2, sao=True,
                                 frame_overlap=True), 5,
     {"TURING_FRAME_THREADS": "1"}, "overlap-sao-q32"),
    ("no-wpp-q32", dict(qp=32, rd_candidates=2, wpp=False), 2,
     {}, ("fe6834fc", "c0dd0a34")),
    ("sao-rdoq-q30", dict(qp=30, rd_candidates=2, sao=True, rdoq=True,
                          sdh=True), 3,
     {}, ("466c47d9", "613c4fe6")),
    ("10bit-q32", dict(qp=32, rd_candidates=2, bit_depth=10), 2,
     {}, ("78804b70", "9b9a061f")),
    # field coding needs height % 16 == 0: crop the clip to 640x352
    ("field-q32", dict(qp=32, rd_candidates=2, field_coding=True,
                       height=352), 2,
     {}, ("01f871da", "8fb4f3a7")),
]


def run(n_decode_frames=24, update=False):
    from turingcodec.decode.decoder import Decoder
    from turingcodec.encode.encoder import (
        Encoder, EncoderConfig, read_yuv_frame)

    data = open(STREAM, "rb").read()
    print(f"decoding {n_decode_frames} frames of reference stream...",
          file=sys.stderr)
    dec = Decoder()
    md5 = hashlib.md5()
    yuv = b""
    for f in dec.decode_stream(data, max_frames=n_decode_frames):
        fb = np.concatenate(
            [p.astype(np.uint8).ravel() for p in f.planes]).tobytes()
        md5.update(fb)
        yuv += fb
    print(f"decode md5({n_decode_frames}): {md5.hexdigest()}")

    failures = 0
    results = {}
    for (name, overrides, n_frames, env, exp) in CONFIGS:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            overrides = dict(overrides)
            overrides.setdefault("height", 360)
            cfg = EncoderConfig(width=640, search_range=16, **overrides)
            enc = Encoder(cfg)
            stream = enc.headers()
            recons = {}
            shift = cfg.bit_depth - 8
            for i in range(n_frames):
                planes = read_yuv_frame(yuv, i, 640, 360)
                if cfg.height != 360:
                    planes = [np.ascontiguousarray(
                        p[:cfg.height >> (0 if k == 0 else 1)])
                        for k, p in enumerate(planes)]
                if shift:
                    planes = [p << shift for p in planes]
                for (idx, nal, recon) in enc.push_frame(planes):
                    stream += nal
                    recons.setdefault(idx, []).append(recon)
            for (idx, nal, recon) in enc.flush():
                stream += nal
                recons.setdefault(idx, []).append(recon)
            # decode our stream; recon must match bit-exactly
            d2 = Decoder()
            ok = True
            rec_md5 = hashlib.md5()
            flat = []
            for idx in sorted(recons):
                flat.extend(recons[idx])
            for k, f in enumerate(d2.decode_stream(stream)):
                for a, b in zip(f.planes, flat[k]):
                    if not np.array_equal(np.asarray(a), np.asarray(b)):
                        ok = False
                if f.hash_ok is False:
                    ok = False
                dt = np.uint16 if shift else np.uint8
                rec_md5.update(np.concatenate(
                    [np.asarray(p).astype(dt).ravel()
                     for p in f.planes]).tobytes())
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        bits4 = hashlib.md5(stream).hexdigest()[:8]
        rec4 = rec_md5.hexdigest()[:8]
        results[name] = (bits4, rec4)
        want = results.get(exp) if isinstance(exp, str) else exp
        status = "OK" if ok else "RECON MISMATCH"
        if not update and want is not None and (bits4, rec4) != want:
            status = f"GOLDEN MISMATCH (want {want})"
        if "OK" not in status:
            failures += 1
        print(f"{name:>24}: bits {bits4}  recon {rec4}  {status}")
    if update:
        print("\npinned goldens:")
        for name, pair in results.items():
            print(f'    "{name}": {pair},')
    return failures


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return 1 if run(update="--update" in argv) else 0


if __name__ == "__main__":
    sys.exit(main())
