"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's: parameter, optimizer-moment, cache (both layouts),
activation and batch specs of every config in ``ARCH_IDS`` at full
width, on fake meshes of the serving and production shapes (nothing is
allocated: the rules read only ``axis_names`` and ``devices.shape``);
``Model.abstract_params`` against ``jax.eval_shape`` of the init; the
port's meshes; and the activation rules held to the layout the
tensor-parallel model code computes in."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.sharding.rules as RJ
import repro_torch.sharding.rules as RT
from repro.configs import ARCH_IDS, SHAPES as SHAPES_J
from repro.configs import get_config as get_config_jax
from repro.configs import input_specs as input_specs_jax
from repro.models import build_model as build_jax
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.launch import mesh as mesh_port
from repro_torch.models import build_model

MESHES = {"1x2": ((1, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _spec(p):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(p)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _flat_jax(tree):
    return {k: _spec(v) for k, v in _flat(jax.tree.map(
        lambda s: s, tree, is_leaf=lambda x: isinstance(x, P))).items()}


@pytest.fixture(scope="module")
def pairs():
    return {a: (build_jax(get_config_jax(a)), build_model(get_config(a)))
            for a in ARCH_IDS}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_match_reference(pairs, arch, mesh):
    mj, mt = pairs[arch]
    fm = FakeMesh(*MESHES[mesh])
    for make in ("make_rules", "make_serving_rules"):
        rj = getattr(RJ, make)(fm, mj.cfg)
        rt = getattr(RT, make)(fm, mt.cfg)
        assert rt.tp_strategy == rj.tp_strategy
        assert rt.param_rules == rj.param_rules
        assert {k: tuple(v) for k, v in rt.act_rules.items()} == \
            {k: tuple(v) for k, v in rj.act_rules.items()}
        assert _flat(RT.params_pspecs(rt, mt)) == \
            _flat_jax(RJ.params_pspecs(rj, mj))
        assert _flat(RT.opt_state_pspecs(rt, mt)) == \
            _flat_jax(RJ.opt_state_pspecs(rj, mj))


def _leaf_specs(flat):
    """{leaf name: sorted (shape-free) specs}: the paged pools of the two
    packages nest their {"k", "v"} leaves differently."""
    out = {}
    for path, spec in flat.items():
        out.setdefault(path.split("/")[-1], []).append(spec)
    return {k: sorted(v, key=repr) for k, v in out.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(pairs, arch, mesh):
    mj, mt = pairs[arch]
    fm = FakeMesh(*MESHES[mesh])
    rj, rt = RJ.make_serving_rules(fm, mj.cfg), RT.make_serving_rules(
        fm, mt.cfg)
    B, C = 128, 32768
    cj = mj.init_cache(B, C, abstract=True)
    ct = mt.init_cache(B, C, device="meta")
    assert _flat(RT.cache_pspecs(rt, ct)) == _flat_jax(RJ.cache_pspecs(rj,
                                                                       cj))
    if mt.prefix_seq_axes() is None:
        with pytest.raises(ValueError):
            mt.init_paged_cache(17, 16, device="meta")
        return
    pj = jax.eval_shape(lambda: mj.init_paged_cache(4097, 16))
    pt = mt.init_paged_cache(4097, 16, device="meta")
    assert _leaf_specs(_flat(RT.cache_pspecs(rt, pt, layout="paged"))) == \
        _leaf_specs(_flat_jax(RJ.cache_pspecs(rj, pj, layout="paged")))
    with pytest.raises(ValueError, match="layout"):
        RT.cache_pspecs(rt, pt, layout="blocky")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_act_and_batch_specs_match_reference(arch, mesh):
    cj, ct = get_config_jax(arch), get_config(arch)
    fm = FakeMesh(*MESHES[mesh])
    rj, rt = RJ.make_rules(fm, cj), RT.make_rules(fm, ct)
    D, H, hd = ct.d_model, ct.num_heads or 1, ct.head_dim or 1
    shapes = {"act_hidden": [(256, 4096, D), (8, 1, D)],
              "act_qkv": [(256, 4096, H, hd), (8, 1, H, hd)],
              "act_kv": [(256, 4096, ct.num_kv_heads or 1, hd)],
              "act_ffn": [(256, 4096, ct.d_ff or 1), (3, 5, 7)],
              "act_logits": [(256, 4096, ct.vocab_padded)],
              "act_expert": [(ct.num_experts or 1, 64, D)],
              "act_expert_ffn": [(ct.num_experts or 1, 64, ct.d_ff or 1)],
              "act_moe_group": [(256, 16, D)],
              "act_expert_grouped": [(256, ct.num_experts or 1, 8, D)],
              "act_lru": [(256, 4096, ct.lru_width or 1)],
              "act_ssm": [(256, 4096, ct.ssm_heads or 1, 64)],
              "no_such_rule": [(4, 4)]}
    for name, cases in shapes.items():
        for shape in cases:
            want = RJ.act_pspec(rj, name, shape)
            got = RT.act_pspec(rt, name, shape)
            assert got == (None if want is None else _spec(want)), \
                (name, shape)
    for sname in SHAPES:
        bj = RJ.batch_pspecs(rj, input_specs_jax(cj, SHAPES_J[sname]))
        bt = RT.batch_pspecs(rt, input_specs(ct, SHAPES[sname]))
        assert _flat(bt) == _flat_jax(bj)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_eval_shape(pairs, arch):
    mj, mt = pairs[arch]
    want = _flat(jax.eval_shape(mj.init, jax.random.PRNGKey(0)))
    got = _flat(mt.abstract_params())
    assert got.keys() == want.keys()
    for k, s in want.items():
        t = got[k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == s.shape and str(t.dtype).split(".")[-1] \
            == str(s.dtype), k
    assert _flat(mt.param_logical_axes()) == _flat(jax.tree.map(
        lambda a: a, mj.param_logical_axes(),
        is_leaf=lambda x: isinstance(x, tuple)))
    bf = _flat(mt.abstract_params(dtype="bfloat16"))
    assert {t.dtype for t in bf.values()} == {torch.bfloat16}
    assert mt.num_params() == mj.num_params()


def test_config_properties_match_reference():
    for a in ARCH_IDS:
        cj, ct = get_config_jax(a), get_config(a)
        for c in (cj, cj.reduced()):
            t = ct if c is cj else ct.reduced()
            assert t.sub_quadratic == c.sub_quadratic
            assert t.is_attention_free == c.is_attention_free


def test_positional_pspec_keeps_its_meaning():
    from repro_torch.models.common import PSpec
    s = PSpec((8, 4), "embed")
    assert s.init == "embed" and s.fan_in_axes == () and s.axes == ()


def test_mesh_construction_and_validation(monkeypatch):
    with pytest.raises(ValueError, match="tp"):
        mesh_port.make_serving_mesh(0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="devices"):
        mesh_port.make_serving_mesh(2)
    with pytest.raises(RuntimeError, match="256"):
        mesh_port.make_production_mesh()
    m = mesh_port.make_serving_mesh(4, devices=["cpu"] * 4)
    assert m.axis_names == ("data", "model")
    assert m.devices.shape == (1, 4) and m.shape == {"data": 1, "model": 4}
    assert all(d == torch.device("cpu") for d in m.device_list())
    pm = mesh_port.make_production_mesh(multi_pod=True,
                                        devices=["meta"] * 512)
    assert pm.shape == {"pod": 2, "data": 16, "model": 16}
    h = mesh_port.make_host_mesh(device="cpu")
    assert h.devices.shape == (1, 1)
    assert h.device_list() == [torch.device("cpu")]
    if not torch.cuda.is_available():     # the default is the card
        with pytest.raises(RuntimeError, match="cuda"):
            mesh_port.make_host_mesh()
    with pytest.raises(ValueError, match="axes"):
        mesh_port.Mesh([["cpu"]], ("model",))
    hw = mesh_port.hardware_constants()
    assert hw == {"peak_flops_bf16": 989e12, "hbm_bandwidth": 3.35e12,
                  "nvlink_bandwidth": 900e9, "hbm_bytes": 80e9}


def test_placement_round_trip_and_reductions():
    from repro_torch.sharding import placement as PL
    mesh = mesh_port.Mesh(np.array(["cpu"] * 8).reshape(2, 2, 2),
                          ("pod", "data", "model"))
    x = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
    for spec in [(None, None, None), (("pod", "data"), "model", None),
                 ("model", None, "pod"), (None, ("data", "model"), None)]:
        st = PL.place(x, PL.NamedSharding(mesh, spec))
        assert torch.equal(st.full(), x)
        assert st.mesh.axis_names == ("pod", "data", "model")
    st = PL.place(x, PL.NamedSharding(mesh, (("pod", "data"), None, None)))
    assert st.local((1, 0, 1)).shape == (1, 8, 2)
    assert torch.equal(st.local((1, 0, 1)), x[2:3])
    with pytest.raises(ValueError, match="split"):
        PL.place(x, PL.NamedSharding(mesh, (None, None, ("pod", "data"))))
    assert PL.local_zeros(x.shape, x.dtype, ("model", None, None), mesh,
                          (0, 0, 1)).shape == (2, 8, 2)
    parts = [torch.full((3,), float(i), dtype=torch.bfloat16)
             for i in range(4)]
    out = PL.reduce_sum(parts)
    assert all(torch.equal(o, torch.full((3,), 6.0, dtype=torch.bfloat16))
               for o in out)
    assert out[0] is out[3]   # one device: one result tensor
    assert torch.equal(PL.reduce_max(parts)[1], parts[3])
    assert torch.equal(PL.gather(parts, 0)[3:6], parts[1])


def test_activation_rules_hold_the_tp_layout():
    """Under ``use_rules`` the tensor-parallel program checks each
    activation's shards against its rule (``constrain_activation``); a
    prefill and a decode step at tp = 2 and 4 pass, and a shard shape
    that differs from its rule raises."""
    import asyncio

    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("stablelm-3b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    for tp in (2, 4):
        mesh = mesh_port.make_serving_mesh(tp, devices=["cpu"] * tp)
        eng = ServingEngine(model, params, max_slots=2, max_len=32,
                            page_size=8, mesh=mesh, device="cpu")

        async def go():
            out = await eng.generate([1, 2, 3, 4, 5], max_new_tokens=3)
            await eng.stop()
            return out
        with RT.use_rules(eng._rules):
            assert len(asyncio.run(go())) == 3
    with RT.use_rules(RT.make_serving_rules(mesh, cfg)):
        RT.constrain_activation("act_ffn", (2, 3, 128), [(2, 3, 32)] * 4)
        with pytest.raises(ValueError, match="act_ffn"):
            RT.constrain_activation("act_ffn", (2, 3, 128), [(2, 3, 128)])
    RT.constrain_activation("act_ffn", (2, 3, 128), [(2, 3, 128)])
