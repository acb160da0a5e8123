"""Debug tool: dump my CABAC bin trace for the first slice of a stream.

Usage: CABAC_TRACE_PY=1 python tools/trace_debug.py [n_frames] 2> my_trace.txt
Compare with the instrumented reference decoder's trace (env CABAC_TRACE=1).
"""
import sys

sys.path.insert(0, "/root/repo")

from turingcodec.decode.decoder import Decoder

n = int(sys.argv[1]) if len(sys.argv) > 1 else 1
data = open("/root/reference/test/excerpt_(CC)_caminandes.com_640x360.hevc", "rb").read()
dec = Decoder()
try:
    for f in dec.decode_stream(data, max_frames=n):
        pass
except Exception as e:
    print(f"EXCEPTION: {e!r}", file=sys.stderr)
