"""The port's tensor parallelism for the families beyond dense and VLM:
MoE on the paged engine (the ``shard_map`` dispatch), the contiguous
layout (reduced recurrentgemma-9b with dense and int8 KV, whose one KV
head splits the ring by sequence; reduced mamba2-2.7b, whose fused
columns are regrouped into heads; the dense opt-out) and whisper-medium
at the model level.  Meshes of repeated CPU devices at tp = 2 and 4,
against the reference's single-device JAX engine (greedy tokens equal)
or its ``encdec`` functions (f32, 1e-5); every shard's cache leaf has
the local shape of the reference's ``cache_pspecs``."""

import asyncio
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from helpers_torch import HYBRID, build_pair  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.sharding import rules as rules_jax  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.sharding.placement import (  # noqa: E402
    ShardedParams,
    regroup,
)
from repro_torch.sharding.rules import (  # noqa: E402
    local_shape,
    make_serving_rules,
    params_pspecs,
)

ENC_TOL = 1e-5
PREFIX = list(range(40, 72))


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [PREFIX + [int(t) for t in rng.randint(1, 500, 3 + 5 * i)]
            for i in range(n)]


# >= 3 tokens (the JAX engine shifts a shorter prompt's conv state,
# ROADMAP §D); 11 and 14 exceed the hybrid's 8-slot window
CONTIG_PROMPTS = [[5, 17, 31], list(range(1, 12)), [42, 5, 6, 7, 8],
                  [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7]]

# name -> (arch, config changes, engine kwargs, prompts, max_new, warm)
CASES = {
    "moe": ("olmoe-1b-7b", dict(moe_capacity_factor=1.25),
            dict(max_slots=8, max_len=96, page_size=16, prefill_chunk=16),
            _prompts(1, 6), 8, PREFIX),
    "hybrid": ("recurrentgemma-9b", HYBRID, dict(max_slots=2, max_len=32),
               CONTIG_PROMPTS, 10, None),
    "hybrid_int8": ("recurrentgemma-9b", dict(HYBRID, kv_cache_dtype="int8"),
                    dict(max_slots=2, max_len=32), CONTIG_PROMPTS, 10, None),
    "ssm": ("mamba2-2.7b", {}, dict(max_slots=3, max_len=32),
            CONTIG_PROMPTS, 6, None),
    "dense_contiguous": ("stablelm-3b", {},
                         dict(max_slots=4, max_len=96,
                              kv_layout="contiguous"),
                         _prompts(2, 3), 6, PREFIX),
}

_PAIRS = {}
_WANT = {}


def _pair(name):
    arch, rep, *_ = CASES[name]
    key = (arch, tuple(sorted(rep.items())))
    if key not in _PAIRS:
        _PAIRS[key] = build_pair(arch, **rep)
    return _PAIRS[key]


async def _serve(engine, prompts, max_new, warm):
    if warm is not None:
        await engine.warm_prefix(warm)
    outs = await asyncio.gather(*[
        engine.generate(p, max_new_tokens=max_new) for p in prompts])
    await engine.stop()
    return [list(o) for o in outs]


def _want(name):
    if name not in _WANT:
        _, mj, params_j, _, _ = _pair(name)
        _, _, kw, prompts, max_new, warm = CASES[name]
        _WANT[name] = asyncio.run(_serve(JaxEngine(mj, params_j, **kw),
                                         prompts, max_new, warm))
    return _WANT[name]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _fake_mesh(tp):
    """What the reference's rules read of a mesh: its axes and shape."""
    return SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((1, tp), dtype=object))


def _reference_local_shapes(mj, tree_abstract, tp, layout="contiguous"):
    cfg = mj.cfg
    rules = rules_jax.make_serving_rules(_fake_mesh(tp), cfg)
    specs = rules_jax.cache_pspecs(rules, tree_abstract, layout=layout)
    sizes = {"data": 1, "model": tp}
    return {p: tuple(local_shape(leaf.shape, tuple(spec), sizes))
            for (p, leaf), (_, spec) in zip(
                _leaves(tree_abstract), _leaves(_spec_tree(specs)))}


def _spec_tree(specs):
    if isinstance(specs, dict):
        return {k: _spec_tree(v) for k, v in specs.items()}
    return specs


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_tp_engine_tokens_equal_jax_engine(name, tp):
    """Greedy tokens of the sharded engine equal the single-device JAX
    engine's; the MoE case drops assignments (capacity factor 1.25)."""
    _, mj, _, mt, params_t = _pair(name)
    _, _, kw, prompts, max_new, warm = CASES[name]
    eng = ServingEngine(mt, params_t, device="cpu",
                        mesh=make_serving_mesh(tp, devices=["cpu"] * tp),
                        **kw)
    copies = regroup.copies
    got = asyncio.run(_serve(eng, prompts, max_new, warm))
    assert got == _want(name)
    tpl = lm.TensorParallel(mt.cfg, eng.params)
    if name == "moe":
        assert eng.kv_layout == "paged" and tpl.experts
    else:
        assert eng.kv_layout == "contiguous"
        assert set(eng.cache) == {lm.shard_key(r) for r in range(tp)}
    if name.startswith("hybrid"):
        assert not tpl.kv_split and tpl.attn_sum   # the sequence split
    if name == "ssm":
        assert regroup.copies > copies


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["hybrid", "hybrid_int8", "ssm",
                                  "dense_contiguous"])
def test_shard_cache_shapes_equal_reference_local_shapes(name, tp):
    """Each shard's slot-cache leaf has the local shape of the
    reference's ``cache_pspecs`` of the same cache."""
    _, mj, _, mt, params_t = _pair(name)
    _, _, kw, *_ = CASES[name]
    eng = ServingEngine(mt, params_t, device="cpu",
                        mesh=make_serving_mesh(tp, devices=["cpu"] * tp),
                        **kw)
    abstract = jax.eval_shape(
        lambda: mj.init_cache(kw["max_slots"], kw["max_len"]))
    want = _reference_local_shapes(mj, abstract, tp)
    for r in range(tp):
        got = {p: tuple(t.shape)
               for p, t in _leaves(eng.cache[lm.shard_key(r)])}
        assert got == want


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["moe", "hybrid", "ssm"])
def test_shard_param_shapes_equal_reference_local_shapes(name, tp):
    _, mj, _, mt, params_t = _pair(name)
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    sp = ShardedParams(params_t, params_pspecs(
        make_serving_rules(mesh, mt.cfg), mt), mesh)
    rules = rules_jax.make_serving_rules(_fake_mesh(tp), mj.cfg)
    specs = dict(_leaves(_spec_tree(rules_jax.params_pspecs(rules, mj))))
    full = dict(_leaves(params_t))
    for shard in sp.shards:
        for p, t in _leaves(shard):
            assert tuple(t.shape) == tuple(local_shape(
                full[p].shape, tuple(specs[p]), {"data": 1, "model": tp}))


# -- whisper-medium at the model level ---------------------------------------


@pytest.fixture(scope="module")
def whisper():
    return build_pair("whisper-medium")


@pytest.mark.parametrize("tp", [2, 4])
def test_encdec_tp_matches_jax(whisper, tp):
    """``prefill`` and eight greedy decode steps over sharded parameters
    against the JAX ``encdec`` (f32, 1e-5); tokens equal, and each
    shard's cache leaf at the reference's local shape."""
    cfg, mj, params_j, mt, params_t = whisper
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    sp = ShardedParams(params_t, params_pspecs(
        make_serving_rules(mesh, cfg), mt), mesh)
    rng = np.random.RandomState(5)
    B, S, cap = 2, 5, 16
    toks = rng.randint(1, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.randn(B, cfg.enc_seq, cfg.d_model).astype(np.float32)
    lj, cj = mj.prefill(params_j, {"tokens": jnp.asarray(toks),
                                   "encoder_frames": jnp.asarray(frames)},
                        cap)
    lt, ct = mt.prefill(sp, {"tokens": torch.as_tensor(toks),
                             "encoder_frames": torch.as_tensor(frames)}, cap)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ENC_TOL,
                               rtol=ENC_TOL)
    abstract = jax.eval_shape(lambda: cj)
    want = _reference_local_shapes(mj, abstract, tp)
    for r in range(tp):
        assert {p: tuple(t.shape) for p, t in _leaves(
            ct[lm.shard_key(r)])} == want
    tj = np.asarray(lj).argmax(-1).astype(np.int32)
    tt = lt.argmax(-1).to(torch.int32)
    for i in range(8):
        pos = np.full((B,), S + i, np.int32)
        lj, cj = mj.decode_step(params_j, cj, jnp.asarray(tj[:, None]),
                                jnp.asarray(pos))
        lt, ct = mt.decode_step(sp, ct, tt[:, None], torch.as_tensor(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ENC_TOL,
                                   rtol=ENC_TOL)
        tj = np.asarray(lj).argmax(-1).astype(np.int32)
        tt = lt.argmax(-1).to(torch.int32)
        assert tt.tolist() == tj.tolist()


def test_moe_tp_dispatch_counts_its_launch_route(monkeypatch):
    """Under a mesh the MoE layers take the ``shard_map`` dispatch."""
    calls = []
    tp_fn = moe.apply_moe_tp

    def spy(cfg, ps, x, devices):
        calls.append(len(ps))
        return tp_fn(cfg, ps, x, devices)
    monkeypatch.setattr(moe, "apply_moe_tp", spy)
    _, _, _, mt, params_t = _pair("moe")
    eng = ServingEngine(mt, params_t, device="cpu", max_slots=2, max_len=32,
                        mesh=make_serving_mesh(2, devices=["cpu"] * 2))
    asyncio.run(_serve(eng, [[5, 6, 7]], 3, None))
    assert calls and set(calls) == {2}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-9b",
                                  "mamba2-2.7b"])
def test_serve_launcher_tp_families(arch, capsys):
    """``python -m repro_torch.launch.serve --tp 2`` (a fleet of one
    tp = 2 replica) for the families this slice shards."""
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", arch, "--tp", "2", "--requests", "3",
          "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "3 requests in" in out and "(tp=2)" in out
