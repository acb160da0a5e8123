"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def test_mesh_analysis_step_8dev():
    from turingcodec.parallel.mesh import make_mesh, sharded_analysis

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh(4, 2)
    fn = sharded_analysis(mesh)
    rng = np.random.default_rng(0)
    shape = (4, 2, 2, 32, 32)
    shard = NamedSharding(mesh, P("frame", "row"))
    ctus = jax.device_put(jnp.asarray(
        rng.integers(0, 256, shape), jnp.int32), shard)
    preds = jax.device_put(jnp.asarray(
        rng.integers(0, 256, shape), jnp.int32), shard)
    qp = jax.device_put(jnp.asarray(26, jnp.int32), NamedSharding(mesh, P()))
    rate, dist, tr, td = fn(ctus, preds, qp)
    jax.block_until_ready((rate, dist, tr, td))
    assert rate.shape == (4, 2, 2)
    assert int(tr) == int(np.asarray(rate).sum())


def test_graft_entry_points():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out[0].shape == (8, 32, 32)
    if len(jax.devices()) >= 8:
        g.dryrun_multichip(8)


def test_gop_scaling_demo(caminandes_bytes, tmp_path):
    """tools/scaling: real-stream GOP workloads sharded over the mesh must
    equal the unsharded per-picture op (exit 0 == bit-exact)."""
    p = tmp_path / "c.hevc"
    p.write_bytes(caminandes_bytes)
    from turingcodec.tools import scaling
    assert scaling.main(["--frames", "4", "--mesh", "4x2", str(p)]) == 0
