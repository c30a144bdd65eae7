"""The port's int8 error-feedback all-reduce
(``repro_torch.training.compression``) against the reference's: bit-equal
means and error buffers at 8 shards with different gradients per shard
(the reference's ``ef_compress_psum`` under ``shard_map`` over
``P("data")`` inputs, in a JAX subprocess with 8 host devices), over
three steps of error feedback; the reference drill's 20-step accumulated
error; and ``wire_bytes``."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.training import compression as comp_ref
from repro_torch.launch.mesh import Mesh
from repro_torch.training import compression as comp

SHARDS = 8
STEPS = 3
# leaf sizes: a chunk multiple, a ragged tail, fewer values than a chunk
SIZES = {"w": 64 * 32, "b": 300, "s": 7}

JAX_SIDE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, "src")
    import jax
    import numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.training.compression import ef_compress_psum

    data = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((8,), ("data",))

    def one(g, e):
        m, ne = ef_compress_psum(g[0], e[0], "data")
        return m[None], ne[None]

    fn = jax.jit(shard_map(one, mesh=mesh,
                           in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data")),
                           check_rep=False))
    out = {}
    for key in sorted({k.split(":")[0] for k in data}):
        err = np.zeros_like(data[f"{key}:0"])
        for step in range({steps}):
            mean, err = fn(data[f"{key}:{step}"], err)
            out[f"{key}:mean:{step}"] = np.asarray(mean)
            out[f"{key}:err:{step}"] = np.asarray(err)
    np.savez(sys.argv[2], **out)
    print("OK")
""").replace("{steps}", str(STEPS))


def _grads():
    """Per (leaf, step): [SHARDS, n] float32, a different gradient on
    every shard, on scales that differ by leaf and by shard."""
    rng = np.random.default_rng(7)
    out = {}
    for key, n in SIZES.items():
        for step in range(STEPS):
            scale = np.exp(rng.normal(size=(SHARDS, 1)))
            out[f"{key}:{step}"] = (rng.normal(size=(SHARDS, n))
                                    * scale).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ef")
    grads = _grads()
    np.savez(d / "in.npz", **grads)
    r = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(d / "in.npz"),
         str(d / "out.npz")],
        capture_output=True, text=True, cwd=".", timeout=300)
    assert "OK" in r.stdout, r.stderr[-2500:]
    return grads, dict(np.load(d / "out.npz"))


def test_ef_compress_psum_bit_equal_at_8_shards(reference):
    grads, want = reference
    for key in SIZES:
        err = [torch.zeros(SIZES[key]) for _ in range(SHARDS)]
        for step in range(STEPS):
            g = torch.from_numpy(grads[f"{key}:{step}"])
            mean, err = comp.ef_compress_psum(list(g), err)
            np.testing.assert_array_equal(
                torch.stack(mean).numpy(), want[f"{key}:mean:{step}"])
            np.testing.assert_array_equal(
                torch.stack(err).numpy(), want[f"{key}:err:{step}"])


def test_allreduce_of_per_shard_trees_bit_equal(reference):
    """``make_compressed_dp_allreduce`` over one tree per shard: every
    leaf as ``ef_compress_psum`` gives it, the shape and dtype kept."""
    grads, want = reference
    mesh = Mesh(np.array(["cpu"] * SHARDS).reshape(1, SHARDS),
                ("model", "data"))
    reduce = comp.make_compressed_dp_allreduce(mesh, "data")
    shapes = {"w": (64, 32), "b": (300,), "s": (7,)}
    trees = [{k: torch.zeros(s) for k, s in shapes.items()}] * SHARDS
    errs = [comp.init_error_buffers(t) for t in trees]
    for step in range(STEPS):
        trees = [{k: torch.from_numpy(grads[f"{k}:{step}"][r]).reshape(s)
                  for k, s in shapes.items()} for r in range(SHARDS)]
        means, errs = reduce(trees, errs)
        for k, s in shapes.items():
            got = torch.stack([m[k] for m in means])
            assert got.shape == (SHARDS,) + s and got.dtype == torch.float32
            np.testing.assert_array_equal(
                got.reshape(SHARDS, -1).numpy(), want[f"{k}:mean:{step}"])
    with pytest.raises(ValueError, match="shards"):
        reduce(trees[:3], errs[:3])


def test_drill_replicated_grads_converge():
    """The reference drill (``tests/test_training.py``): replicated grads
    over 8 shards, 20 steps; error feedback keeps the accumulated mean
    within 2e-3 of the exact sum."""
    mesh = Mesh(np.array(["cpu"] * SHARDS).reshape(SHARDS), ("data",))
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.normal(size=(64, 32))).float(),
             "b": torch.from_numpy(rng.normal(size=(128,))).float()}
    errs = comp.init_error_buffers(grads)
    assert {k: tuple(v.shape) for k, v in errs.items()} == \
        {"w": (2048,), "b": (128,)}
    reduce = comp.make_compressed_dp_allreduce(mesh, "data")
    acc = torch.zeros_like(grads["w"])
    exact = torch.zeros_like(grads["w"])
    for _ in range(20):
        mean, errs = reduce(grads, errs)
        acc = acc + mean["w"]
        exact = exact + grads["w"]
    rel = float(torch.linalg.norm(acc - exact) / torch.linalg.norm(exact))
    assert rel < 2e-3, rel


@pytest.mark.parametrize("n", [1, 255, 256, 257, 2048, 10**6 + 3])
def test_wire_bytes_match_reference(n):
    for chunk in (128, 256):
        assert comp.wire_bytes(n, chunk) == comp_ref.wire_bytes(n, chunk)
    assert comp.wire_bytes(n) < 4 * n or n < 8
