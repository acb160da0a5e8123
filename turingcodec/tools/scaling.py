"""GOP-parallel scaling demo: the real decode pixel pipeline sharded over
a (frame, row) device mesh, driven by real bitstream workloads.

Usage:
    python -m turingcodec.tools.scaling [--frames N] [--mesh FxR]
                                            [stream.hevc]

What it does (SURVEY.md §2.7 mapping; ROADMAP multi-host story):
  1. Host CABAC parse of N inter pictures -> plan tensors (the serial
     stage; one picture per "frame" shard in a real deployment).
  2. Stacks every picture's 4x4-block motion + residual workloads into
     (F, B) tensors and runs the sharded GOP MC + residual steps from
     parallel/gop_decode.py over the mesh — "frame" = concurrent-frames
     analogue, "row" = WPP analogue (block batch partition).
  3. Asserts the sharded outputs are bit-exact with the per-picture
     unsharded ops, and reports per-stage wall time and device placement.

On a CPU host, set XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu for a virtual 8-device mesh (correctness/placement
validation; CPU "devices" share the same cores, so wall time is not a
scaling claim). On several GPUs the same script measures actual
scaling; on one GPU use --mesh 1x1 for single-device op throughput.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

CAMINANDES = ("/root/reference/test/"
              "excerpt_(CC)_caminandes.com_640x360.hevc")


def _pad_pow2(n, lo=128):
    p = lo
    while p < n:
        p <<= 1
    return p


def gather_workloads(stream: bytes, n_frames: int):
    """Host parse: per-picture luma MC workloads from real plans."""
    from turingcodec.decode.decoder import Decoder

    dec = Decoder()
    works = []

    # hook picture completion to capture plan + ref list before recon
    import turingcodec.decode.picture_recon as pr
    orig_run = pr.PictureReconstructor.run

    def hooked(self):
        plan, geom = self.plan, self.geom
        inter = (plan.cu_pred_mode == 0) & (plan.cu_id >= 0) & (
            plan.ref_idx[0] >= 0)
        if inter.any() and self.ref_lists and self.ref_lists[0]:
            by4, bx4 = np.nonzero(inter)
            lx = 0
            r = plan.ref_idx[lx, by4, bx4].astype(np.int32)
            mvx = plan.mv[lx, by4, bx4, 0].astype(np.int32)
            mvy = plan.mv[lx, by4, bx4, 1].astype(np.int32)
            refs = np.stack([p.planes[0] for p in self.ref_lists[lx][:4]])
            works.append(dict(
                refs=refs.astype(np.int16),
                sel=np.minimum(np.maximum(r, 0), refs.shape[0] - 1),
                xi=bx4.astype(np.int32) * 4 + (mvx >> 2),
                yi=by4.astype(np.int32) * 4 + (mvy >> 2),
                xf=mvx & 3, yf=mvy & 3))
        return orig_run(self)

    pr.PictureReconstructor.run = hooked
    try:
        for i, _f in enumerate(dec.decode_stream(stream)):
            if len(works) >= n_frames:
                break
    finally:
        pr.PictureReconstructor.run = orig_run
    return works


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stream", nargs="?", default=CAMINANDES)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--mesh", default=None,
                    help="FxR, e.g. 4x2 (default: use all devices)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from turingcodec.ops.inter import mc_block_grid
    from turingcodec.parallel.mesh import make_mesh
    from turingcodec.parallel.gop_decode import sharded_gop_mc

    devs = jax.devices()
    if args.mesh:
        f_ax, r_ax = (int(v) for v in args.mesh.split("x"))
    else:
        n = len(devs)
        f_ax = min(args.frames, n)
        while n % f_ax:
            f_ax -= 1
        r_ax = n // f_ax
    print(f"devices: {len(devs)} x {devs[0].platform}  "
          f"mesh: frame={f_ax} row={r_ax}")

    t0 = time.time()
    data = open(args.stream, "rb").read()
    works = gather_workloads(data, args.frames)
    t_parse = time.time() - t0
    if len(works) < f_ax:
        print(f"only {len(works)} inter pictures; shrink mesh")
        f_ax = max(1, len(works))
        r_ax = 1
    works = works[: (len(works) // f_ax) * f_ax] or works[:1]
    fdim = len(works)
    print(f"host parse+decode of {fdim} inter pictures: {t_parse:.2f}s")

    # stack to (F, B) with common padded B and common ref count
    bpad = _pad_pow2(max(len(w["sel"]) for w in works))
    rmax = max(w["refs"].shape[0] for w in works)
    hh, ww = works[0]["refs"].shape[1:]

    def padb(a, n, fill=0):
        out = np.full(n, fill, np.int32)
        out[: len(a)] = a
        return out

    refs = np.zeros((fdim, rmax, hh, ww), np.int16)
    cols = {k: np.zeros((fdim, bpad), np.int32)
            for k in ("sel", "xi", "yi", "xf", "yf")}
    nb = []
    for i, wk in enumerate(works):
        refs[i, : wk["refs"].shape[0]] = wk["refs"]
        for k in cols:
            cols[k][i] = padb(wk[k], bpad)
        nb.append(len(wk["sel"]))

    mesh = make_mesh(f_ax, r_ax)
    step = sharded_gop_mc(mesh, bs=4, taps=8, bit_depth=8)
    from jax.sharding import NamedSharding, PartitionSpec as P
    fr_sh = NamedSharding(mesh, P("frame"))
    bl_sh = NamedSharding(mesh, P("frame", "row"))

    def put():
        r = jax.device_put(jnp.asarray(refs), fr_sh)
        c = {k: jax.device_put(jnp.asarray(v), bl_sh)
             for k, v in cols.items()}
        return r, c

    r_d, c_d = put()
    out = step(r_d, c_d["sel"], c_d["xi"], c_d["yi"], c_d["xf"],
               c_d["yf"])
    out.block_until_ready()  # compile
    t0 = time.time()
    out = step(r_d, c_d["sel"], c_d["xi"], c_d["yi"], c_d["xf"],
               c_d["yf"])
    out.block_until_ready()
    t_mc = time.time() - t0
    blocks = int(sum(nb))
    print(f"sharded GOP MC: {fdim} pictures x {bpad} blocks "
          f"({blocks} real) in {t_mc * 1e3:.1f} ms "
          f"= {blocks / max(t_mc, 1e-9) / 1e6:.1f} M real blocks/s")

    # bit-exactness vs the unsharded per-picture op
    host = np.asarray(out)
    ok = True
    for i, wk in enumerate(works):
        want = np.asarray(mc_block_grid(
            jnp.asarray(wk["refs"]), jnp.asarray(wk["sel"]),
            jnp.asarray(wk["xi"]), jnp.asarray(wk["yi"]),
            jnp.asarray(wk["xf"]), jnp.asarray(wk["yf"]), 4, 8, 8))
        ok &= bool((host[i, : nb[i]] == want).all())
    print("sharded == unsharded:", "BIT-EXACT" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
