"""The port's sharded MoE dispatches against the reference's own code.

``apply_moe_tp`` (the ``shard_map`` dispatch: each shard runs its experts
on the replicated tokens, one ``reduce_sum`` adds the partial outputs) on
meshes of repeated CPU devices against the reference's
``apply_moe_shardmap`` under ``make_serving_rules(make_serving_mesh(tp))``
in a JAX subprocess with 4 host devices, at tp = 2 and 4 and capacity
factors 8.0 (dropless) and 1.25 (assignments drop).  The weights are one
MoE layer of reduced olmoe-1b-7b from the port's seeded init
(``helpers_torch.build_pair``: which assignments drop depends on them).
``apply_moe_grouped`` against the reference's at g = 2 and 4, in
process; and ``apply_moe`` picks each dispatch under the rules the
reference's picks it under."""

import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from helpers_torch import build_pair  # noqa: E402
from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.models import moe as moe_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_serving_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import to_numpy  # noqa: E402
from repro_torch.sharding.rules import make_serving_rules, use_rules  # noqa

ARCH = "olmoe-1b-7b"
Y_TOL = 1e-5
AUX_TOL = 1e-6
CFS = (8.0, 1.25)
TPS = (2, 4)

JAX_SIDE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import sys
    sys.path.insert(0, "src")
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_serving_mesh
    from repro.models.moe import apply_moe_shardmap
    from repro.sharding.rules import make_serving_rules, use_rules

    data = dict(np.load(sys.argv[1]))
    p = {k: jnp.asarray(data[k]) for k in ("router", "w_gate", "w_up",
                                           "w_down")}
    x = jnp.asarray(data["x"])
    out = {}
    for cf in (8.0, 1.25):
        cfg = get_config("olmoe-1b-7b").reduced().replace(
            moe_capacity_factor=cf)
        for tp in (2, 4):
            rules = make_serving_rules(make_serving_mesh(tp), cfg)
            with use_rules(rules):
                y, aux = apply_moe_shardmap(cfg, p, x, rules)
            out[f"y:{cf}:{tp}"] = np.asarray(y)
            out[f"aux:{cf}:{tp}"] = np.asarray(aux)
    np.savez(sys.argv[2], **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def layer():
    """One MoE layer's parameters (layer 0 of the port's seeded init) and
    a token batch [2, 12, D]."""
    _, _, _, mt, params_t = build_pair(ARCH)
    p = {k: v[0] for k, v in params_t["layers"]["b0"]["moe"].items()}
    x = np.random.RandomState(4).randn(
        2, 12, mt.cfg.d_model).astype(np.float32)
    return to_numpy(p), x


@pytest.fixture(scope="module")
def reference(layer, tmp_path_factory):
    p, x = layer
    d = tmp_path_factory.mktemp("moe_tp")
    np.savez(d / "in.npz", x=x, **p)
    r = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(d / "in.npz"),
         str(d / "out.npz")],
        capture_output=True, text=True, cwd=".", timeout=300)
    assert "OK" in r.stdout, r.stderr[-2500:]
    return dict(np.load(d / "out.npz"))


def _cfg(cf):
    return get_config(ARCH).reduced().replace(moe_capacity_factor=cf)


def _drops(cfg, p, x):
    _, _, idx = moe.route(cfg, p, x.reshape(-1, x.shape[-1]))
    return int((moe.queue_positions(idx, cfg.num_experts)
                >= moe.expert_capacity(cfg, idx.shape[0])).sum())


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("cf", CFS)
def test_apply_moe_tp_matches_reference_shardmap(layer, reference, cf, tp):
    p_np, x_np = layer
    cfg = _cfg(cf)
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    x = torch.from_numpy(x_np)
    devices = ["cpu"] * tp
    y, aux = moe.apply_moe_tp(cfg, moe.expert_shards(p, devices), x,
                              devices)
    np.testing.assert_allclose(y.numpy(), reference[f"y:{cf}:{tp}"],
                               atol=Y_TOL, rtol=Y_TOL)
    np.testing.assert_allclose(aux.numpy(), reference[f"aux:{cf}:{tp}"],
                               atol=AUX_TOL, rtol=AUX_TOL)
    assert (_drops(cfg, p, x) > 0) == (cf == 1.25)


@pytest.mark.parametrize("tp", TPS)
def test_apply_moe_picks_shard_map_under_rules(layer, reference, tp):
    """Under the port's serving rules on a mesh of tp devices,
    ``apply_moe`` (the default ``moe_dispatch="shard_map"``) takes the
    sharded dispatch and agrees with the reference's."""
    p_np, x_np = layer
    cfg = _cfg(1.25)
    assert cfg.moe_dispatch == "shard_map"
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    calls = []
    tp_fn = moe.apply_moe_tp

    def spy(*a, **k):
        calls.append(1)
        return tp_fn(*a, **k)
    moe.apply_moe_tp = spy
    try:
        mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
        with use_rules(make_serving_rules(mesh, cfg)):
            y, _ = moe.apply_moe(cfg, p, torch.from_numpy(x_np))
    finally:
        moe.apply_moe_tp = tp_fn
    assert calls
    np.testing.assert_allclose(y.numpy(), reference[f"y:1.25:{tp}"],
                               atol=Y_TOL, rtol=Y_TOL)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("cf", CFS)
def test_apply_moe_grouped_matches_reference(layer, cf, g):
    p_np, x_np = layer
    cfg_j = get_config_jax(ARCH).reduced().replace(moe_capacity_factor=cf)
    yj, auxj = moe_jax.apply_moe_grouped(
        cfg_j, {k: jnp.asarray(v) for k, v in p_np.items()},
        jnp.asarray(x_np), g)
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    y, aux = moe.apply_moe_grouped(_cfg(cf), p, torch.from_numpy(x_np), g)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=Y_TOL,
                               rtol=Y_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(auxj), atol=AUX_TOL,
                               rtol=AUX_TOL)


def test_apply_moe_picks_grouped_where_the_data_axis_exceeds_one(layer):
    """``moe_dispatch="grouped"`` under rules whose data axis is 4: the
    grouped dispatch, with per-group capacity (so at 1.25 it differs from
    the global dispatch, which sees every token at once)."""
    p_np, x_np = layer
    cfg = _cfg(1.25).replace(moe_dispatch="grouped")
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    x = torch.from_numpy(x_np)
    mesh = Mesh(np.array(["cpu"] * 4).reshape(4, 1), ("data", "model"))
    with use_rules(make_serving_rules(mesh, cfg)):
        y, _ = moe.apply_moe(cfg, p, x)
    want, _ = moe.apply_moe_grouped(cfg, p, x, 4)
    torch.testing.assert_close(y, want, atol=0, rtol=0)
    glob, _ = moe.apply_moe_global(cfg, p, x)
    assert not torch.equal(y, glob)
    y1, _ = moe.apply_moe(cfg, p, x)     # no rules: global
    torch.testing.assert_close(y1, glob, atol=0, rtol=0)
