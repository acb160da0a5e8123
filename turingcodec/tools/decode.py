"""CLI: decode an HEVC bitstream to YUV.

Usage: python -m turingcodec.tools.decode input.hevc [-o out.yuv]
           [--frames N] [--md5 EXPECTED]

Parity reference: the `turing decode` subcommand (turing/decode.cpp:86,
turing/main.cpp:54-162).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec decode")
    ap.add_argument("input")
    ap.add_argument("-o", "--output-file", default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="number of frames to decode")
    ap.add_argument("--md5", default=None,
                    help="verify output YUV md5 against this hex digest")
    ap.add_argument("--no-progress", action="store_true")
    ap.add_argument("--device", dest="device", action="store_true",
                    default=None,
                    help="run the chained decode pipeline on the JAX "
                         "device (default: when the backend is the GPU)")
    ap.add_argument("--no-device", dest="device", action="store_false")
    args = ap.parse_args(argv)

    from turingcodec.decode.decoder import decode_to_yuv
    from turingcodec.utils.device import (describe_choice, device_stages_on,
                                          enable_compile_cache)

    enable_compile_cache()
    device = device_stages_on(args.device)
    print(describe_choice(device), file=sys.stderr)
    data = open(args.input, "rb").read()
    t0 = time.time()
    digest, n = decode_to_yuv(data, max_frames=args.frames,
                              out_path=args.output_file, device=device)
    dt = time.time() - t0
    if not args.no_progress:
        print(f"decoded {n} frames in {dt:.1f}s ({n / dt:.2f} fps)  "
              f"md5 {digest}", file=sys.stderr)
    if args.md5 is not None:
        if digest != args.md5.lower():
            print(f"MD5 MISMATCH: got {digest}, want {args.md5}",
                  file=sys.stderr)
            return 1
        print("md5 OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
