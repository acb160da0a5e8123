"""GOP-parallel device decode: the per-picture MC block grid (the real
pixel-pipeline op from ops/inter.mc_block_grid, not a toy) sharded over a
(frame, row) device mesh.

- "frame" axis: pictures of a GOP decode concurrently (the reference's
  --concurrent-frames, TaskEncodeInput.cpp throttle); each frame's
  reference stack and block grid live on that frame's devices.
- "row" axis: the block batch of one picture shards across devices (the
  WPP-row analogue) — MC blocks are independent, so the batch dimension
  partitions freely; XLA keeps the gathers local to each shard.

Host CABAC parse produces the plan tensors per frame; this step consumes
the stacked (F, B) block-motion tensors and returns (F, B, 4, 4)
predictions. Residual dequant+IDCT batches shard the same way (pure
elementwise/matmul ops over the batch axis).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from turingcodec.ops.inter import mc_block_grid


def sharded_gop_mc(mesh: Mesh, bs: int = 4, taps: int = 8,
                   bit_depth: int = 8):
    """jit the stacked-GOP MC step with (frame, row) shardings.

    Inputs: refs (F, R, H, W) sharded on frame; sel/xi/yi/xf/yf (F, B)
    sharded on (frame, row). Output (F, B, bs, bs) sharded likewise.
    """
    def step(refs, sel, xi, yi, xf, yf):
        fn = lambda r, s, a, b, c, d: mc_block_grid(r, s, a, b, c, d,
                                                    bs, taps, bit_depth)
        return jax.vmap(fn)(refs, sel, xi, yi, xf, yf)

    blocks = NamedSharding(mesh, P("frame", "row"))
    frames = NamedSharding(mesh, P("frame"))
    return jax.jit(step,
                   in_shardings=(frames, blocks, blocks, blocks, blocks,
                                 blocks),
                   out_shardings=blocks)


def sharded_gop_residual(mesh: Mesh, bit_depth: int = 8, log2_size: int = 3):
    """jit the stacked residual dequant+IDCT step: (F, N, n, n) coefficient
    batches sharded over (frame, row) -> residual batches."""
    from turingcodec.ops.quant import dequant_batch
    from turingcodec.ops.transform import inverse_transform_batch

    def step(blocks, qps):
        def one(b, q):
            d = dequant_batch(b, q, bit_depth, log2_size)
            return inverse_transform_batch(d, bit_depth, False)
        return jax.vmap(one)(blocks, qps)

    sh = NamedSharding(mesh, P("frame", "row"))
    return jax.jit(step, in_shardings=(sh, sh), out_shardings=sh)


def sharded_gop_deblock(mesh: Mesh, ctb_log2: int = 6, bd_y: int = 8,
                        bd_c: int = 8):
    """jit the stacked deblocking step over the 'frame' axis: each frame's
    planes + plan maps live on that frame's devices (loop filters have
    in-picture data flow, so the frame axis is the honest shard axis —
    the reference's per-picture TaskDeblock wavefront, TaskDeblock.cpp).

    Inputs (all leading dim F): ry (F,H,W), rcb/rcr (F,H/2,W/2), maps =
    the 11-tuple of decode/device_pipeline._deblock_device plan maps,
    sl = the 6-tuple of per-slice vectors, across (F,) bool.
    """
    from turingcodec.ops.deblock import deblock_device

    def step(ry, rcb, rcr, maps, sl, across):
        fn = lambda y, cb, cr, m, s, a: deblock_device(  # noqa: E731
            y, cb, cr, m, s, ctb_log2, bd_y, bd_c, a)
        return jax.vmap(fn)(ry, rcb, rcr, maps, sl, across)

    fr = NamedSharding(mesh, P("frame"))
    return jax.jit(step, in_shardings=(fr, fr, fr, fr, fr, fr),
                   out_shardings=(fr, fr, fr))


def sharded_gop_sao(mesh: Mesh, ctb: int = 64, bd: int = 8, sub: int = 1):
    """jit the stacked SAO step for one component over the 'frame' axis
    (TaskSao analogue): src (F,H,W), per-CTB sao_type/class (F,hc,wc),
    offsets (F,hc,wc,4), upsampled slice/tile/skip maps (F,H,W), per-slice
    enable/across vectors (F,S), across_tiles (F,) bool."""
    from turingcodec.ops.sao import _sao_plane

    def step(src, sao_type, sao_class, sao_off, slice_up, tile_up,
             enable_s, across_s, across_tiles, skip_up):
        fn = lambda s, t, c, o, su, tu, en, ac, at, sk: _sao_plane(  # noqa
            s, ctb, bd, sub, t, c, o, su, tu, en, ac, at, sk)
        return jax.vmap(fn)(src, sao_type, sao_class, sao_off, slice_up,
                            tile_up, enable_s, across_s, across_tiles,
                            skip_up)

    fr = NamedSharding(mesh, P("frame"))
    return jax.jit(step, in_shardings=(fr,) * 10, out_shardings=fr)
