"""The port's tensor-parallel paged engine (``ServingEngine(mesh=)``) on
meshes of repeated CPU devices against the reference's single-device JAX
engine on the same (converted) parameters: greedy tokens exactly equal,
at tp = 2 and 4 on reduced stablelm-3b and pixtral-12b, and where the
rules fall back to replication (KV heads that do not divide tp; heads
and the MLP's hidden dim that do not).  The reference's own tp cells
fail on JAX 0.9 (ROADMAP §D), and its engine is token-identical across
tp by design, so its single-device engine is the yardstick.  Also: each
shard's pool holds ``paged_kv_pool_bytes / tp``, a fleet of two tp = 2
replicas over four devices, the layouts a mesh once refused served,
and what a mesh still refuses raising."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from helpers_torch import SCENARIOS
from repro.configs import get_config as get_config_jax
from repro.models import build_model as build_jax
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import paged_kv_pool_bytes
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax
from repro_torch.models.lm import TensorParallel
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.fleet import EngineFleet
from repro_torch.serving.prefix_cache import tree_nbytes
from repro_torch.sharding.placement import ShardedParams
from repro_torch.sharding.rules import make_rules, params_pspecs

torch.set_num_threads(1)

# (arch, config changes): the second pixtral's 2 KV heads do not divide
# tp = 4 (its q heads do: the KV pool is replicated and each shard reads
# only its KV heads); stablelm at tp = 8 replicates its 4 heads and its
# hidden dim of 100
MODELS = {"stablelm": ("stablelm-3b", {}),
          "pixtral": ("pixtral-12b", {}),
          "pixtral_kv2": ("pixtral-12b", dict(num_kv_heads=2)),
          "stablelm_ffn100": ("stablelm-3b", dict(d_ff=100))}


@pytest.fixture(scope="module")
def models():
    out = {}
    for key, (arch, rep) in MODELS.items():
        mj = build_jax(get_config_jax(arch).reduced().replace(**rep))
        pj = mj.init(jax.random.PRNGKey(11))
        mt = build_model(get_config(arch).reduced().replace(**rep))
        pt = from_jax(mt.cfg, jax.tree.map(np.asarray, pj), device="cpu")
        out[key] = (mj, pj, mt, pt)
    return out


def _serve(engine, prompts, max_new, warm):
    async def go():
        if warm is not None:
            await engine.warm_prefix(warm)
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=max_new) for p in prompts])
        await engine.stop()
        return [list(o) for o in outs]
    return asyncio.run(go())


_WANT = {}


def _reference(models, key, name):
    if (key, name) not in _WANT:
        mj, pj, _, _ = models[key]
        kw, prompts, max_new, warm = SCENARIOS[name]
        _WANT[key, name] = _serve(JaxEngine(mj, pj, **kw), prompts, max_new,
                                  warm)
    return _WANT[key, name]


def _tp_engine(models, key, tp, **kw):
    _, _, mt, pt = models[key]
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    return ServingEngine(mt, pt, mesh=mesh, device="cpu", **kw)


@pytest.mark.parametrize("name", ["concurrent", "shared_prefix", "chunked"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("key", ["stablelm", "pixtral"])
def test_tp_tokens_equal_reference_single_device(models, key, tp, name):
    kw, prompts, max_new, warm = SCENARIOS[name]
    eng = _tp_engine(models, key, tp, **kw)
    got = _serve(eng, prompts, max_new, warm)
    assert got == _reference(models, key, name)
    st = eng.stats()
    assert st["kv_layout"] == "paged" and st["kv_admit_copies"] == 0
    if name == "shared_prefix":
        assert st["prefill_tokens_reused"] > 0
    tpl = TensorParallel(eng.cfg, eng.params)
    assert tpl.attn_sum and tpl.ffn_sum and tpl.vocab
    assert tpl.kv_heads == [None] * tp


@pytest.mark.parametrize("key,tp,split", [
    ("pixtral_kv2", 4, dict(attn_sum=True, ffn_sum=True, kv_heads=[
        (0, 1), (0, 1), (1, 2), (1, 2)])),
    ("stablelm_ffn100", 8, dict(attn_sum=False, ffn_sum=False,
                                kv_heads=[None] * 8))])
def test_tp_replication_fallbacks(models, key, tp, split):
    """Where a dim falls back to replication the shards hold the whole
    product and nothing is summed twice; where the KV heads replicate
    under sharded q heads each shard reads only its own KV heads."""
    kw, prompts, max_new, warm = SCENARIOS["shared_prefix"]
    eng = _tp_engine(models, key, tp, **kw)
    got = _serve(eng, prompts, max_new, warm)
    assert got == _reference(models, key, "shared_prefix")
    tpl = TensorParallel(eng.cfg, eng.params)
    assert {k: getattr(tpl, k) for k in split} == split
    # a replicated pool: every shard holds all KV heads
    _, _, mt, _ = models[key]
    kvh = mt.cfg.num_kv_heads
    assert {tuple(s["k"].shape)[3] for s in eng.kv_pages.values()} == {kvh}


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_pool_bytes(models, tp):
    _, _, mt, _ = models["stablelm"]
    eng = _tp_engine(models, "stablelm", tp, max_slots=4, max_len=64,
                     page_size=16)
    want = paged_kv_pool_bytes(mt.cfg, num_pages=eng.num_pages,
                               page_size=16)
    assert len(eng.kv_pages) == tp
    for shard in eng.kv_pages.values():
        assert tree_nbytes(shard) == want // tp
        assert shard["k"].shape[3] == mt.cfg.num_kv_heads // tp
    single = ServingEngine(mt, models["stablelm"][3], max_slots=4,
                           max_len=64, page_size=16, device="cpu")
    assert tree_nbytes(single.kv_pages) == want
    # the radix budget counts the logical pool, as the reference's does
    assert eng.prefix_cache.budget_pages == single.prefix_cache.budget_pages


def test_fleet_of_tp_replicas(models):
    _, _, mt, pt = models["stablelm"]
    kw, prompts, max_new, _ = SCENARIOS["concurrent"]
    fleet = EngineFleet(mt, pt, replicas=2, tp=2, devices=["cpu"] * 4,
                        device="cpu", **kw)
    assert [e.mesh.shape["model"] for e in fleet.engines] == [2, 2]
    want = _reference(models, "stablelm", "concurrent")
    for e in fleet.engines:
        assert _serve(e, prompts, max_new, None) == want
    with pytest.raises(RuntimeError, match="devices"):
        EngineFleet(mt, pt, tp=4, devices=["cpu"] * 2, device="cpu")


@pytest.mark.parametrize("arch,rep,kw", [
    ("stablelm-3b", {}, dict(kv_layout="contiguous")),
    ("olmoe-1b-7b", {}, {}),
    ("recurrentgemma-9b", dict(num_layers=5, attn_window=8), {})])
def test_mesh_serves_what_it_refused(arch, rep, kw):
    """The layouts the mesh once refused (the contiguous opt-out, MoE, the
    hybrid's contiguous cache) now serve: tokens equal the one-device
    port engine's (held against the JAX engine in
    ``test_torch_serving_tp_families.py``)."""
    m = build_model(get_config(arch).reduced().replace(**rep))
    p = m.init(0, device="cpu")
    prompts = [[5, 17, 31, 2], [9, 8, 7]]
    want = _serve(ServingEngine(m, p, device="cpu", max_slots=2, max_len=32,
                                **kw), prompts, 4, None)
    eng = ServingEngine(m, p, device="cpu", max_slots=2, max_len=32,
                        mesh=make_serving_mesh(2, devices=["cpu"] * 2), **kw)
    assert _serve(eng, prompts, 4, None) == want


def test_mesh_refuses_what_it_does_not_shard(models):
    """The encoder-decoder engine (a request carries no encoder frames, as
    the reference's) and head-dim-sharded strategies (serving runs the
    heads strategy).  Recurrent widths that do not split are served
    replicated (``test_torch_serving_tp_fallbacks.py``)."""
    mesh = make_serving_mesh(2, devices=["cpu"] * 2)
    w = build_model(get_config("whisper-medium").reduced())
    with pytest.raises(NotImplementedError, match="encoder"):
        ServingEngine(w, w.init(0, device="cpu"), mesh=mesh, device="cpu")
    _, _, mt, pt = models["stablelm"]
    ulysses = make_rules(mesh, mt.cfg.replace(tp_strategy="ulysses"))
    with pytest.raises(NotImplementedError, match="head_dim"):
        TensorParallel(mt.cfg, ShardedParams(pt, params_pspecs(ulysses, mt),
                                             mesh))
