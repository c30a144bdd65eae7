"""The port's sharded serving program where the serving rules replicate
what does not divide the shard count: RG-LRU widths and SSD heads and
columns, K/V rings whose KV heads and slots both fail to split, KV heads
that whisper's shards cannot split, and q heads that read replicated KV
heads in unequal groups.  Meshes of repeated CPU devices at tp = 3 (and
5, and 2 for one SSD layout), in float32, against the reference's
single-device JAX engine (greedy tokens equal) or its ``encdec``
functions (1e-5).  Every shard's cache leaf has the local shape of the
reference's ``cache_pspecs``, and every leaf the rules replicate is
bit-equal across the shards after decoding.  The sharded train step
runs each of these layouts, held to the one-device step, and the
dry-run's ``ulysses_sp`` decode step a cache split by KV heads."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from helpers_torch import HYBRID, build_pair  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.sharding import rules as rules_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_serving_mesh  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import build_model, encdec, lm  # noqa: E402
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
from test_torch_serving_tp_families import (  # noqa: E402
    CONTIG_PROMPTS,
    ENC_TOL,
    _fake_mesh,
    _leaves,
    _prompts,
    _spec_tree,
)

GQA = dict(num_heads=12, num_kv_heads=4)

# name -> (arch, config changes, tp, engine kwargs, prompts, max_new,
# the TensorParallel flags the layout must give)
CASES = {
    # everything replicated: width 64, 4 q heads over 1 KV head, d_ff 128,
    # the 8-slot ring
    "hybrid": ("recurrentgemma-9b", HYBRID, 3, dict(max_slots=2, max_len=32),
               CONTIG_PROMPTS, 8, dict(lru=False, attn_sum=False,
                                       ffn_sum=False, vocab=False)),
    "hybrid_int8": ("recurrentgemma-9b", dict(HYBRID, kv_cache_dtype="int8"),
                    3, dict(max_slots=2, max_len=32), CONTIG_PROMPTS, 8,
                    dict(lru=False, attn_sum=False)),
    # full-width recurrentgemma-9b's layout over three shards: only the
    # MLPs split
    "hybrid_mlp_split": ("recurrentgemma-9b", dict(HYBRID, d_ff=192), 3,
                         dict(max_slots=2, max_len=32), CONTIG_PROMPTS, 8,
                         dict(lru=False, attn_sum=False, ffn_sum=True)),
    # 8 heads and 160 conv columns: nothing of the block splits
    "ssm": ("mamba2-2.7b", {}, 3, dict(max_slots=3, max_len=32),
            CONTIG_PROMPTS, 6, dict(ssd_heads=False, ssd_fused=False,
                                    ssd_conv=False)),
    # full-width mamba2-2.7b's layout over three shards: the conv's 156
    # columns split, w_in's 292 and the 8 heads do not
    "ssm_conv_split": ("mamba2-2.7b", dict(ssm_state=14), 3,
                       dict(max_slots=3, max_len=32), CONTIG_PROMPTS, 6,
                       dict(ssd_heads=False, ssd_fused=False,
                            ssd_conv=True)),
    # one head of 128 over two shards: w_out's rows and the conv split,
    # the head and w_in's 289 columns do not
    "ssm_one_head": ("mamba2-2.7b", dict(ssm_headdim=128), 2,
                     dict(max_slots=3, max_len=32), CONTIG_PROMPTS, 6,
                     dict(ssd_heads=False, ssd_fused=False, ssd_conv=True)),
    # 4 q and 4 KV heads over three shards: a 64-slot ring split neither way
    "dense_contiguous": ("stablelm-3b", {}, 3,
                         dict(max_slots=4, max_len=64,
                              kv_layout="contiguous"),
                         _prompts(2, 3)[:2], 6,
                         dict(attn_sum=False, kv_split=False)),
    # q heads [4r, 4r + 4) over 4 KV heads in groups of 3: shards 0 and 2
    # read theirs in unequal groups
    "gqa_paged": ("stablelm-3b", GQA, 3,
                  dict(max_slots=4, max_len=64, page_size=16,
                       prefill_chunk=16), _prompts(3, 4), 6,
                  dict(attn_sum=True, kv_split=False)),
    "gqa_contiguous": ("stablelm-3b", GQA, 3,
                       dict(max_slots=4, max_len=64, kv_layout="contiguous"),
                       _prompts(4, 3)[:2], 6,
                       dict(attn_sum=True, kv_split=False)),
    # qwen3-14b's grouping at tp = 5: 8 q heads a shard over 8 KV heads
    # in groups of 5
    "qwen3_tp5": ("qwen3-14b", dict(num_heads=40, num_kv_heads=8), 5,
                  dict(max_slots=4, max_len=64, page_size=16,
                       prefill_chunk=16), _prompts(5, 3), 6,
                  dict(attn_sum=True, kv_split=False)),
}

_PAIRS = {}


def _pair(arch, rep):
    key = (arch, tuple(sorted(rep.items())))
    if key not in _PAIRS:
        _PAIRS[key] = build_pair(arch, **rep)
    return _PAIRS[key]


async def _serve(engine, prompts, max_new):
    outs = await asyncio.gather(*[
        engine.generate(p, max_new_tokens=max_new) for p in prompts])
    await engine.stop()
    return [list(o) for o in outs]


def _reference_specs(mj, tree, tp, layout):
    rules = rules_jax.make_serving_rules(_fake_mesh(tp), mj.cfg)
    return dict(_leaves(_spec_tree(rules_jax.cache_pspecs(
        rules, tree, layout=layout))))


def _check_shards(shards, specs, abstract, tp):
    """Each shard's leaf at the reference's local shape; a leaf the rules
    replicate bit-equal across the shards.  → the replicated leaves."""
    full = dict(_leaves(abstract))
    per = [dict(_leaves(s)) for s in shards]
    replicated = []
    for path, spec in specs.items():
        want = tuple(local_shape(full[path].shape, tuple(spec),
                                 {"data": 1, "model": tp}))
        assert all(tuple(p[path].shape) == want for p in per), path
        if "model" not in tuple(spec):
            replicated.append(path)
            assert all(torch.equal(p[path], per[0][path]) for p in per[1:]), \
                path
    return replicated


@pytest.mark.parametrize("name", list(CASES))
def test_fallback_tokens_equal_jax_engine(name):
    """Greedy tokens of the sharded engine equal the single-device JAX
    engine's; the layout gives the case's flags; every shard's cache or
    pool leaf has the reference's local shape, and the replicated ones
    are bit-equal across shards after decoding."""
    arch, rep, tp, kw, prompts, max_new, flags = CASES[name]
    _, mj, params_j, mt, params_t = _pair(arch, rep)
    want = asyncio.run(_serve(JaxEngine(mj, params_j, **kw), prompts,
                              max_new))
    eng = ServingEngine(mt, params_t, device="cpu",
                        mesh=make_serving_mesh(tp, devices=["cpu"] * tp),
                        **kw)
    copies = regroup.copies
    assert asyncio.run(_serve(eng, prompts, max_new)) == want
    tpl = lm.TensorParallel(mt.cfg, eng.params)
    assert {k: getattr(tpl, k) for k in flags} == flags
    if eng.paged_kv:           # the port's pool: {"k", "v"} [L, P, ...]
        abstract = mt.init_paged_cache(eng.num_pages + 1, kw["page_size"],
                                       device="meta")
        shards, layout = eng.kv_pages, "paged"
    else:
        abstract = jax.eval_shape(lambda: mj.init_cache(kw["max_slots"],
                                                        kw["max_len"]))
        shards, layout = eng.cache, "contiguous"
    assert set(shards) == {lm.shard_key(r) for r in range(tp)}
    replicated = _check_shards(list(shards.values()), _reference_specs(
        mj, abstract, tp, layout), abstract, tp)
    assert replicated
    if name.startswith("gqa") or name == "qwen3_tp5":
        assert lm.uneven_groups(tpl.kv_runs)
    if name == "ssm_conv_split":       # the conv output gathered to the scan
        assert regroup.copies > copies


def test_qwen3_tp5_runs():
    """The runs of full-width qwen3-14b's q heads at tp = 5 (40 q heads
    over 8 KV heads): each shard's 8 q heads in runs of equal groups;
    ``kv_head_range`` still refuses the unequal ones."""
    runs = [att.kv_head_runs(40, 8, 8 * r, 8) for r in range(5)]
    assert runs == [((0, 5, 0, 1), (5, 8, 1, 2)),
                    ((0, 2, 1, 2), (2, 7, 2, 3), (7, 8, 3, 4)),
                    ((0, 8, 3, 5),),
                    ((0, 1, 4, 5), (1, 6, 5, 6), (6, 8, 6, 7)),
                    ((0, 3, 6, 7), (3, 8, 7, 8))]
    assert att.kv_head_range(40, 8, 16, 8) == (3, 5)
    with pytest.raises(NotImplementedError, match="unequal groups"):
        att.kv_head_range(40, 8, 0, 8)
    # equal groups everywhere: one run a shard
    assert [att.kv_head_runs(32, 8, 8 * r, 8) for r in range(4)] == [
        ((0, 8, 2 * r, 2 * r + 2),) for r in range(4)]


# -- whisper-medium at the model level ---------------------------------------


def test_encdec_tp3_matches_jax():
    """Reduced whisper at tp = 3 with 24 encoder frames: 4 q and 4 KV
    heads, the MLPs and the vocab replicated; the 16-slot self cache
    whole on every shard, the cross memory split by sequence (8 frames a
    shard: a partial a shard and one combine).  ``prefill`` and eight
    greedy decode steps against the JAX ``encdec`` (f32, 1e-5)."""
    tp = 3
    cfg, mj, params_j, mt, params_t = _pair("whisper-medium",
                                            dict(enc_seq=24))
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    sp = ShardedParams(params_t, params_pspecs(
        make_serving_rules(mesh, cfg), mt), mesh)
    tpl = encdec.EncDecTP(cfg, sp)
    assert not (tpl.attn_sum or tpl.kv_split or tpl.ffn_sum or tpl.vocab)
    rng = np.random.RandomState(7)
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
    specs = _reference_specs(mj, abstract, tp, "contiguous")
    assert "model" in specs[("dec", "cross_k")]
    assert "model" not in specs[("dec", "k")]
    tj = np.asarray(lj).argmax(-1).astype(np.int32)
    tt = lt.argmax(-1).to(torch.int32)
    for i in range(8):
        pos = np.full((B,), S + i, np.int32)
        lj, cj = mj.decode_step(params_j, cj, jnp.asarray(tj[:, None]),
                                jnp.asarray(pos))
        lt, ct = mt.decode_step(sp, ct, tt[:, None], torch.as_tensor(pos),
                                capacity=cap)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ENC_TOL,
                                   rtol=ENC_TOL)
        tj = np.asarray(lj).argmax(-1).astype(np.int32)
        tt = lt.argmax(-1).to(torch.int32)
        assert tt.tolist() == tj.tolist()
    replicated = _check_shards([ct[lm.shard_key(r)] for r in range(tp)],
                               specs, abstract, tp)
    assert ("dec", "k") in replicated and ("dec", "v") in replicated
    with pytest.raises(ValueError, match="pass the capacity"):
        mt.decode_step(sp, ct, tt[:, None], torch.as_tensor(pos))


def test_ulysses_decode_over_a_head_split_cache_refuses():
    """Reduced qwen3-14b under ``ulysses_sp`` on a model axis that divides
    its KV heads: the rules split the cache by KV heads and keep every
    slot, and the attention weights come gathered whole.  The dry-run's
    decode step runs it: each shard writes and attends its own KV heads
    with the q heads that read them (``lm.heads_view``) and the outputs
    are summed as under ``heads``.  Four steps' logits
    against the one-device ``decode_step`` (f32, 1e-5)."""
    from repro_torch.sharding import rules as R
    cfg = get_config("qwen3-14b").reduced().replace(
        tp_strategy="ulysses_sp")
    model = build_model(cfg)
    rls = R.make_rules(_mesh((1, 2)), cfg)
    assert rls.tp_strategy == "ulysses_sp"
    assert cfg.num_kv_heads % 2 == 0
    B, cap = 2, 16
    cache = model.init_cache(B, cap, device="cpu")
    specs = dict(_leaves(_spec_tree(R.cache_pspecs(rls, cache))))
    # [L, B, C, KVH, hd]: the KV heads split, the slots whole
    assert specs and all(tuple(s)[3] == "model" and tuple(s)[2] is None
                         for s in specs.values())
    params = model.init(seed=0, device="cpu")
    placed = ST.place_cache(rls, cache)
    step = ST.make_decode_step(model, rls, cap)
    rng = np.random.RandomState(3)
    for t in range(4):
        tok = torch.as_tensor(rng.randint(1, cfg.vocab_size, (B, 1)),
                              dtype=torch.int32)
        pos = torch.full((B,), t, dtype=torch.int32)
        want, cache = model.decode_step(params, cache, tok, pos)
        got = step(ST.place_params(model, rls, params), placed, tok, pos)
        torch.testing.assert_close(got[0], want, rtol=ENC_TOL, atol=ENC_TOL)
    for name, st in _leaves(placed):
        torch.testing.assert_close(st.full(), dict(_leaves(cache))[name],
                                   rtol=ENC_TOL, atol=ENC_TOL)


# -- the sharded train step's replicated, ZeRO-2 and ulysses layouts ----------


def _mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(["cpu"] * n, dtype=object).reshape(shape),
                ("data", "model"))


# name -> (arch, config changes, mesh, the strategy the rules pick, the
# batch's sequence length)
TRAIN_REFUSALS = {
    "ulysses": ("stablelm-3b", dict(tp_strategy="ulysses"), (1, 2),
                "ulysses", 16),
    "heads_sp": ("stablelm-3b", dict(tp_strategy="heads_sp"), (1, 2),
                 "heads_sp", 16),
    "ulysses_sp_moe": ("olmoe-1b-7b", dict(tp_strategy="ulysses_sp"),
                       (1, 2), "ulysses_sp", 16),
    "ulysses_sp_hybrid": ("recurrentgemma-9b", {}, (1, 3), "ulysses_sp", 12),
    "ulysses_sp_encdec": ("whisper-medium", {}, (1, 3), "ulysses_sp", 16),
    "zero2": ("stablelm-3b", dict(param_strategy="zero2"), (2, 1),
              "heads", 16),
    "rglru_width": ("recurrentgemma-9b", dict(tp_strategy="heads"), (1, 3),
                    "heads", 16),
    "ssd": ("mamba2-2.7b", {}, (1, 3), "heads", 16),
    "gqa_groups": ("stablelm-3b", GQA, (1, 3), "heads", 16),
    "encdec_kv": ("whisper-medium", dict(tp_strategy="heads"), (1, 3),
                  "heads", 16),
}


@pytest.mark.parametrize("name", list(TRAIN_REFUSALS))
def test_train_step_refuses_what_it_does_not_run(name):
    """Each of these layouts runs in the sharded train step, held to the
    one-device step by
    ``test_torch_train_tp.hold_sharded_step``: loss, every coordinate's
    gradient (every replica of a replicated leaf given the same), the
    state after one step, and every replica bit-equal after three."""
    from repro_torch.sharding import rules as R
    from test_torch_train_tp import _batch, hold_sharded_step
    arch, rep, shape, strategy, S = TRAIN_REFUSALS[name]
    cfg = get_config(arch).reduced().replace(**rep)
    assert R.make_rules(_mesh(shape), cfg).tp_strategy == strategy
    if name in ("rglru_width", "ssd", "gqa_groups", "encdec_kv"):
        specs = params_pspecs(R.make_rules(_mesh(shape), cfg),
                              build_model(cfg))
        tpl = (encdec.EncDecTP if cfg.family == "enc_dec"
               else lm.TensorParallel).from_specs(cfg, specs, shape[1])
        assert not getattr(tpl, {"rglru_width": "lru", "ssd": "ssd_heads",
                                 "gqa_groups": "kv_split",
                                 "encdec_kv": "kv_split"}[name])
    hold_sharded_step(cfg, shape, _batch(cfg, S=S))
