"""Decoder robustness (turing/RangeLimits.h + Violation.h analogue):
bit-flipped streams must produce clause-tagged Violations or decode
cleanly — never raw exceptions or native crashes. The sweep runs in a
child process so a native abort is reported as a failure instead of
killing the test run."""
import subprocess
import sys

import pytest

from turingcodec.decode.violations import Violation

CAMINANDES = "/root/reference/test/excerpt_(CC)_caminandes.com_640x360.hevc"

_WORKER = r'''
import sys
sys.path.insert(0, "/root/repo")
from turingcodec.decode.decoder import Decoder
from turingcodec.decode.violations import Violation
data = bytearray(open("%s", "rb").read())
start = int(sys.argv[1])
positions = %s
for pos in positions:
    if pos < start:
        continue
    for bit in (0x01, 0x40):
        print("AT", pos, bit, flush=True)
        mut = bytearray(data)
        mut[pos] ^= bit
        try:
            dec = Decoder()
            for _ in dec.decode_stream(bytes(mut), max_frames=2):
                pass
        except Violation:
            pass
        except Exception as e:
            print("RAW", pos, bit, type(e).__name__, str(e)[:80],
                  flush=True)
print("DONE", flush=True)
''' % (CAMINANDES, "%s")


def _sweep(positions):
    """Run the bit-flip sweep; returns (raw_exceptions, native_crashes)."""
    raw, crashes = [], []
    start = 0
    body = _WORKER % repr(list(positions))
    while True:
        r = subprocess.run([sys.executable, "-c", body, str(start)],
                           capture_output=True, text=True, timeout=900)
        last_at = None
        for line in r.stdout.splitlines():
            if line.startswith("AT "):
                last_at = tuple(int(x) for x in line.split()[1:3])
            elif line.startswith("RAW "):
                raw.append(line)
        if "DONE" in r.stdout:
            break
        # child died mid-case (native abort/segfault)
        crashes.append((last_at, r.returncode))
        if last_at is None:
            break
        start = last_at[0] + 1   # resume after the killer position
    return raw, crashes


def test_header_bitflips_never_crash():
    raw, crashes = _sweep(range(6, 200))
    assert not crashes, f"native crashes at {crashes[:6]}"
    assert not raw, raw[:6]


def test_slice_data_bitflips_never_crash():
    raw, crashes = _sweep(range(400, 4000, 120))
    assert not crashes, f"native crashes at {crashes[:6]}"
    assert not raw, raw[:6]


def test_violation_is_clause_tagged():
    # violations are either recorded (header NALs: record-and-skip,
    # Violation.h robustness semantics) or raised (slice data); both must
    # carry the spec clause tag
    from turingcodec.decode.decoder import Decoder
    data = bytearray(open(CAMINANDES, "rb").read())
    seen = 0
    for pos in range(10, 80):
        mut = bytearray(data)
        mut[pos] ^= 0x20
        try:
            dec = Decoder()
            for _ in dec.decode_stream(bytes(mut), max_frames=1):
                pass
            for rec in dec.violations:
                if "[" in rec and "]" in rec:
                    seen += 1
        except Violation as v:
            assert v.clause and v.clause[0].isdigit(), v.clause
            seen += 1
        except Exception:
            pass
    assert seen >= 3, f"only {seen} clause-tagged violations seen"
