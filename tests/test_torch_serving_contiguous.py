"""The port's contiguous serving engine against the JAX engine.

The dense opt-out (``kv_layout="contiguous"`` on reduced stablelm-3b:
prefix-aware prefill over a radix trie of KV segments, spliced into a
slot) runs the paged tests' scenarios against the JAX engine's opt-out.

Models whose cache cannot be cut by position (hybrid RG-LRU/local
attention, int8 KV) take the contiguous layout: one exact-length prefill
per admission, copied into a slot of one ``[.., max_slots, C, ..]``
cache, and batched ``Model.decode_step``.  Both engines serve
``recurrentgemma-9b.reduced()`` (5 layers, window 8, so long prompts roll
the ring and decode wraps it) on the same parameters; greedy tokens must
be *equal*.  For prompts shorter than the conv history (1-2 tokens) the
JAX engine shifts the conv state (``ROADMAP.md`` §D), so the port is held
against greedy decoding by the JAX ``forward`` there.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from helpers_torch import HYBRID, SCENARIOS, build_pair  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.serving.decode_graph import leaf_ptrs  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402

KW = dict(max_slots=2, max_len=32)
# ≥ 3 tokens: the JAX engine is exact there; 11 and 14 exceed the window
PROMPTS = [[5, 17, 31], list(range(1, 12)), [42, 5, 6, 7, 8],
           [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7]]
MAX_NEW = 10   # decode wraps the 8-slot ring for every prompt


@pytest.fixture(scope="module", params=["", "int8"], ids=["kv", "int8kv"])
def served(request):
    return build_pair("recurrentgemma-9b", kv_cache_dtype=request.param,
                      **HYBRID)


async def _serve(engine, prompts, max_new):
    outs = await asyncio.gather(*[
        engine.generate(p, max_new_tokens=max_new) for p in prompts])
    await engine.stop()
    return outs


def test_greedy_tokens_equal_jax_engine(served):
    """More requests than slots, prompts inside and beyond the window."""
    _, mj, params_j, mt, params_t = served
    want = asyncio.run(_serve(JaxEngine(mj, params_j, **KW), PROMPTS,
                              MAX_NEW))
    et = ServingEngine(mt, params_t, device="cpu", **KW)
    got = asyncio.run(_serve(et, PROMPTS, MAX_NEW))
    assert got == want
    assert all(len(o) == MAX_NEW for o in got)
    st = et.stats()
    assert (st["kv_layout"], st["paged"], st["prefill_shape_bound"]) \
        == ("contiguous", False, None)
    assert st["kv_admit_copies"] == st["prefill_chunks"] == len(PROMPTS)
    assert st["prefill_tokens_computed"] == sum(map(len, PROMPTS))
    assert st["prefix_cache"] is None and max(et.batch_occupancy) == 2
    assert sorted(et.free_slots) == [0, 1] and not et.active


def _greedy_forward(mj, params_j, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        logits, _ = mj.forward(params_j,
                               {"tokens": jnp.asarray([toks], jnp.int32)})
        toks.append(int(np.asarray(logits)[0, -1].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("prompt", [[5], [5, 17]], ids=["1tok", "2tok"])
def test_short_prompts_equal_greedy_forward(served, prompt):
    """Prompts shorter than conv_width - 1: the port's engine gives the
    tokens of greedy decoding by the reference's ``forward``."""
    _, mj, params_j, mt, params_t = served
    et = ServingEngine(mt, params_t, device="cpu", **KW)
    got = asyncio.run(_serve(et, [prompt], 6))[0]
    assert got == _greedy_forward(mj, params_j, prompt, 6)


def test_paged_model_keeps_contiguous_opt_out_raising():
    """``kv_layout="contiguous"`` for a model the paged layout serves
    builds the contiguous engine with its radix trie of KV segments and
    bucketed prefix-aware prefill; an unknown layout is still refused."""
    _, _, _, mt, params_t = build_pair("stablelm-3b")
    eng = ServingEngine(mt, params_t, device="cpu", kv_layout="contiguous",
                        max_len=64)
    assert (eng.kv_layout, eng.paged_kv) == ("contiguous", False)
    assert isinstance(eng.prefix_cache, PrefixCache)
    assert eng.stats()["prefill_buckets"] == [16, 32, 64]
    assert eng.prefill_shape_bound == 12
    with pytest.raises(ValueError, match="kv_layout"):
        ServingEngine(mt, params_t, device="cpu", kv_layout="ring")


def test_cancelled_request_frees_its_slot(served):
    """A request dropped while it decodes gives its slot back; the
    survivors still get the JAX engine's tokens."""
    _, mj, params_j, mt, params_t = served

    async def go(engine):
        keep = [asyncio.create_task(engine.generate(p, max_new_tokens=6))
                for p in PROMPTS[:2]]
        drop = asyncio.create_task(engine.generate(PROMPTS[2],
                                                   max_new_tokens=20))
        await asyncio.sleep(0)
        drop.cancel()
        outs = await asyncio.gather(*keep)
        await asyncio.gather(drop, return_exceptions=True)
        await engine.stop()
        return outs

    want = asyncio.run(go(JaxEngine(mj, params_j, max_slots=3, max_len=32)))
    et = ServingEngine(mt, params_t, device="cpu", max_slots=3, max_len=32)
    assert asyncio.run(go(et)) == want
    assert sorted(et.free_slots) == [0, 1, 2] and not et.active


# ---------------------------------------------------------------------------
# the dense opt-out: kv_layout="contiguous" for a model the paged layout
# serves (radix trie of KV segments, bucketed chunked prefill, slot splice)


@pytest.fixture(scope="module")
def dense():
    return build_pair("stablelm-3b")


def _pins(cache):
    stack, refs = list(cache.root.children.values()), []
    while stack:
        nd = stack.pop()
        refs.append(nd.refs)
        stack.extend(nd.children.values())
    return refs


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_contiguous_opt_out_equals_jax_engine(dense, name):
    """The existing serving scenarios through both engines with
    ``kv_layout="contiguous"``: the same greedy tokens, one KV copy per
    admission, the same prefix reuse and prefix-cache stats, and no pin
    left behind."""
    _, mj, params_j, mt, params_t = dense
    kw, prompts, max_new, warm = SCENARIOS[name]
    ej = JaxEngine(mj, params_j, kv_layout="contiguous", **kw)
    et = ServingEngine(mt, params_t, device="cpu", kv_layout="contiguous",
                       **kw)
    want = asyncio.run(_serve_warm(ej, prompts, max_new, warm))
    got = asyncio.run(_serve_warm(et, prompts, max_new, warm))
    assert got == want
    st, sj = et.stats(), ej.stats()
    for key in ("kv_layout", "kv_admit_copies", "prefill_tokens_reused",
                "prefill_tokens_computed", "prefill_chunks",
                "prefill_compilations", "prefill_shape_bound",
                "prefill_buckets", "prefix_cache", "steps"):
        assert st[key] == sj[key], key
    assert st["kv_admit_copies"] == len(prompts)
    if warm is not None:
        assert st["prefill_tokens_reused"] > 0
    assert not any(_pins(et.prefix_cache)), "leaked pin"
    assert sorted(et.free_slots) == list(range(kw["max_slots"]))


async def _serve_warm(engine, prompts, max_new, warm):
    if warm is not None:
        await engine.warm_prefix(warm)
    return await _serve(engine, prompts, max_new)


def test_prefix_cache_stats_equal_reference():
    """The contiguous radix trie on one sequence of inserts (a split, a
    skipped insert), pinned matches, releases and budget evictions: the
    same matches, assembled KV and ``stats()`` as the reference's."""
    from repro.serving.prefix_cache import PrefixCache as PrefixCacheJax

    axes = {"k": 1, "v": 1}
    rng = np.random.RandomState(0)
    kv = {n: rng.randn(2, 24, 3).astype(np.float32) for n in axes}

    def tree(lo, hi, jax_side):
        return {n: (jnp.asarray(a[:, lo:hi]) if jax_side
                    else torch.from_numpy(a[:, lo:hi].copy()))
                for n, a in kv.items()}

    budget = 2 * 2 * 14 * 3 * 4          # 14 positions of both leaves
    a, b = tuple(range(10)), tuple(range(6)) + (50, 51, 52)
    c = tuple(range(100, 112))
    runs = []
    for jax_side, cls in ((True, PrefixCacheJax), (False, PrefixCache)):
        pc = cls(axes, budget)
        out = [pc.insert(a, tree(0, 10, jax_side)),
               pc.insert(b, tree(0, 9, jax_side))]       # splits a at 6
        m, got, h = pc.match_and_pin(a + (7,))
        out.append((m, {n: np.asarray(t) for n, t in got.items()}))
        out.append(pc.insert(c, tree(0, 12, jax_side)))  # pinned: skipped
        pc.release(h)
        out.append(pc.insert(c, tree(0, 12, jax_side)))  # evicts LRU leaves
        out += [pc.probe(b), pc.probe(c[:5]), pc.stats()]
        runs.append(out)
    (ref, mine) = runs
    assert ref[2][0] == mine[2][0] == 10
    for n in axes:
        np.testing.assert_array_equal(ref[2][1][n], mine[2][1][n])
    assert ref[:2] + ref[3:] == mine[:2] + mine[3:]
    assert mine[-1]["splits"] == 1 and mine[-1]["skipped_inserts"] == 1
    assert mine[-1]["evictions"] > 0


def test_contiguous_decode_inputs_are_static_buffers(served):
    """On the CPU each decode step runs eagerly over the engine's static
    input buffers, which hold the host state of that step and never
    move."""
    _, _, _, mt, params_t = served
    et = ServingEngine(mt, params_t, device="cpu", **KW)
    ptrs = leaf_ptrs(et._step_state())
    seen = []
    step = et._decode_step

    def spy():
        seen.append(np.array_equal(et._tokens_dev.numpy(), et._cur_tokens)
                    and np.array_equal(et._positions_dev.numpy(),
                                       et._positions))
        return step()

    et._decode_step = spy
    asyncio.run(_serve(et, PROMPTS[:2], 4))
    assert len(seen) == et.steps > 0 and all(seen)
    assert leaf_ptrs(et._step_state()) == ptrs
    assert et.stats()["decode_graph"] is None
