"""The port's paged serving engine against the JAX engine.

Both engines are built from the same parameters (JAX init, converted with
``convert.from_jax``) on reduced stablelm-3b (float32) and run the same
scenarios; greedy tokens must be *equal*.  The JAX engine runs its default
``attention_impl="xla"``; the port runs on the CPU, where its kernel
wrappers take their plain versions.
"""

import asyncio
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.sampler import sample_tokens as sample_jax  # noqa: E402
from repro.serving.tokenizer import ByteTokenizer as TokJax  # noqa: E402
from helpers_torch import PREFIX, SCENARIOS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402
from repro_torch.serving.decode_graph import (  # noqa: E402
    DecodeGraph, LaunchTally, leaf_ptrs)
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serving.tokenizer import ByteTokenizer  # noqa: E402


@pytest.fixture(scope="module")
def served():
    cfg_j = get_config_jax("stablelm-3b").reduced()
    mj = build_jax(cfg_j)
    params_j = mj.init(jax.random.PRNGKey(7))
    cfg = get_config("stablelm-3b").reduced()
    mt = build_model(cfg)
    params_t = from_jax(cfg, jax.tree.map(np.asarray, params_j),
                        device="cpu")
    return (mj, params_j), (mt, params_t)


async def _serve(engine, prompts, max_new, warm):
    if warm is not None:
        await engine.warm_prefix(warm)
    outs = await asyncio.gather(*[
        engine.generate(p, max_new_tokens=max_new) for p in prompts])
    await engine.stop()
    return outs


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_greedy_tokens_equal_jax_engine(served, name):
    (mj, pj), (mt, pt) = served
    kw, prompts, max_new, warm = SCENARIOS[name]
    ej = JaxEngine(mj, pj, **kw)
    et = ServingEngine(mt, pt, device="cpu", **kw)
    want = asyncio.run(_serve(ej, prompts, max_new, warm))
    got = asyncio.run(_serve(et, prompts, max_new, warm))
    assert got == want
    assert all(len(o) == max_new for o in got)
    st = et.stats()
    assert st["kv_admit_copies"] == 0
    assert st["prefill_compilations"] <= st["prefill_shape_bound"]
    if name == "concurrent":
        assert max(et.batch_occupancy) >= 2
    if name == "shared_prefix":
        assert st["prefill_tokens_reused"] > 0
        assert st["prefill_tokens_reused"] == ej.prefill_tokens_reused
    if name == "chunked":
        assert et.prefill_chunks == ej.prefill_chunks >= 6
    if name == "backpressure":
        assert et.admit_stalls > 0 and et.allocator.page_faults > 0
    # every page is free again or owned by the trie alone
    trie = et.prefix_cache.pages if et.prefix_cache is not None else 0
    assert not et._slot_pages
    assert et.allocator.free_count == et.num_pages - trie


def test_cancellation_returns_pages(served):
    """Cancelled requests (hedge losers, dropped clients) give back their
    slot pages and trie pins; the survivors' tokens equal the JAX
    engine's, and the allocator's free count returns to its start."""
    (mj, pj), (mt, pt) = served

    async def go(engine):
        start = engine.allocator.free_count
        await engine.warm_prefix(PREFIX)
        keep = [asyncio.create_task(
            engine.generate(PREFIX + [100 + i], max_new_tokens=6))
            for i in range(2)]
        drop = [asyncio.create_task(
            engine.generate(PREFIX + [200 + i], max_new_tokens=24))
            for i in range(2)]
        await asyncio.sleep(0)
        for t in drop:
            t.cancel()
        outs = await asyncio.gather(*keep)
        await asyncio.gather(*drop, return_exceptions=True)
        await engine.stop()
        return outs, start

    want, _ = asyncio.run(go(JaxEngine(mj, pj, max_slots=4, max_len=64,
                                       page_size=16)))
    et = ServingEngine(mt, pt, max_slots=4, max_len=64, page_size=16,
                       device="cpu")
    got, start = asyncio.run(go(et))
    assert got == want
    assert et.prefix_cache.stats()["tokens_matched"] > 0
    assert not et._slot_pages and not et.active
    for nd in et.prefix_cache.root.children.values():
        assert nd.refs == 0, "leaked pin"
    et.reset_prefix_cache()
    assert et.allocator.free_count == start == et.num_pages


def test_unsupported_engine_options_raise(served):
    """Only ``mesh=`` is still refused; ``kv_layout="contiguous"`` and
    ``metrics=`` build engines, and requests that could never be admitted
    are refused at submission."""
    _, (mt, pt) = served
    with pytest.raises(NotImplementedError, match="mesh"):
        ServingEngine(mt, pt, device="cpu", mesh=object())
    registry = MetricsRegistry()
    eng = ServingEngine(mt, pt, device="cpu", kv_layout="contiguous",
                        metrics=registry)
    assert eng.kv_layout == "contiguous" and eng.metrics is registry
    assert isinstance(eng.prefix_cache, PrefixCache)
    eng = ServingEngine(mt, pt, max_slots=2, max_len=64, page_size=16,
                        num_pages=2, device="cpu", metrics=registry)
    assert registry.snapshot()["serving_pages_free"]["value"] == 2

    async def go():
        with pytest.raises(ValueError, match="pages"):
            await eng.generate(list(range(20)), max_new_tokens=20)
        with pytest.raises(ValueError, match="max_len"):
            await eng.generate(list(range(64)), max_new_tokens=1)
    asyncio.run(go())


def test_decode_inputs_are_static_buffers(served):
    """On the CPU every decode step runs eagerly over the static input
    buffers a CUDA engine's graph replays: tokens and positions are copied
    in each step, the page table only when a slot's row changed, and no
    buffer or pool leaf moves."""
    _, (mt, pt) = served
    et = ServingEngine(mt, pt, max_slots=4, max_len=64, device="cpu")
    ptrs = leaf_ptrs(et._step_state())
    seen = []
    step = et._decode_step

    def spy():
        seen.append(np.array_equal(et._tokens_dev.numpy(), et._cur_tokens)
                    and np.array_equal(et._positions_dev.numpy(),
                                       et._positions)
                    and np.array_equal(et._table_dev.numpy(),
                                       et._page_table))
        return step()

    et._decode_step = spy
    prompts = [[1, 2, 3], [9, 8, 7], [42, 5, 6], [3, 1, 4]]
    asyncio.run(_serve(et, prompts, 12, None))
    assert len(seen) == et.steps >= 12 and all(seen)
    assert 0 < et.table_uploads < et.steps
    assert et.stats()["paged"]["table_uploads"] == et.table_uploads
    assert leaf_ptrs(et._step_state()) == ptrs
    assert et.stats()["decode_graph"] is None


def test_launch_tally_counts_each_replay_as_an_eager_step():
    """The capture counts no launch, each replay adds what one eager step
    counts, and a failed capture leaves the counters as they were."""
    counters = {n: types.SimpleNamespace(launches=k)
                for n, k in (("paged", 5), ("flash", 2), ("ssd", 0))}

    def step():                      # one eager step's launches
        counters["paged"].launches += 3
        counters["ssd"].launches += 1

    def counts():
        return {n: c.launches for n, c in counters.items()}

    tally = LaunchTally(counters)
    step()                           # the eager warm-up step counts
    with tally.capturing():
        step()
    assert counts() == {"paged": 8, "flash": 2, "ssd": 1}
    assert tally.per_replay == {"paged": 3, "ssd": 1}
    for _ in range(4):
        tally.replayed()
    assert counts() == {"paged": 8 + 4 * 3, "flash": 2, "ssd": 1 + 4}
    with pytest.raises(RuntimeError), tally.capturing():
        step()
        raise RuntimeError("capture failed")
    assert counts() == {"paged": 20, "flash": 2, "ssd": 5}


def test_launch_tally_counts_each_replay_by_launch_key():
    """The launches by key follow the totals: the capture adds none, each
    replay adds one eager step's keys, a failed capture leaves them as
    they were."""
    import collections

    from repro_torch.kernels import _build

    @_build.counted
    def paged(key):
        _build.count_launch(paged, key)

    a, b = (("B", 8), ("d", 160)), (("B", 4), ("d", 160))

    def step():
        for _ in range(3):
            paged(a)
        paged(b)

    tally = LaunchTally({"paged": paged})
    step()
    with tally.capturing():
        step()
    assert paged.launches == 4 and paged.shapes == {a: 3, b: 1}
    assert tally.per_replay_shapes == {"paged": {a: 3, b: 1}}
    for _ in range(2):
        tally.replayed()
    assert paged.launches == 12
    assert paged.shapes == collections.Counter({a: 9, b: 3})
    with pytest.raises(RuntimeError), tally.capturing():
        step()
        raise RuntimeError("capture failed")
    assert paged.shapes == {a: 9, b: 3}


def test_decode_graph_refuses_a_moved_cache():
    """A replay after a cache leaf was rebound raises instead of writing
    into the memory the graph captured."""
    state = {"k": torch.zeros(4), "v": torch.zeros(4)}
    graph = DecodeGraph(lambda: None, lambda: state, counters={})
    graph.graph = types.SimpleNamespace(replay=lambda: None)
    graph._ptrs = leaf_ptrs(state)
    graph.replay()
    assert graph.stats()["replays"] == 1
    state["v"] = torch.zeros(4)
    with pytest.raises(RuntimeError, match="moved"):
        graph.replay()


def test_port_engine_behind_local_backend_through_poppy(served):
    """A PopPy program's parallel ``llm()`` calls reach the port's engine
    through the unchanged ``LocalEngineBackend`` and share decode steps."""
    from repro.core import poppy
    from repro.core.ai import llm, use_backend
    from repro.serving.backend import LocalEngineBackend

    _, (mt, pt) = served
    engine = ServingEngine(mt, pt, max_slots=4, max_len=64, device="cpu")
    backend = LocalEngineBackend(engine)

    @poppy
    def fanout(n):
        outs = tuple()
        for i in range(n):
            outs += (llm(f"prompt {i}", max_tokens=4),)
        return outs

    with use_backend(backend):
        outs = fanout(4)
    assert len(outs) == 4 and all(isinstance(o, str) for o in outs)
    assert engine.decode_tokens > 0
    assert max(engine.batch_occupancy) >= 2, \
        "parallel PopPy calls did not share decode batches"


# ---------------------------------------------------------------------------
# sampler and tokenizer


def _sampling_logits(kind):
    if kind == "3x11":
        logits = np.random.RandomState(5).randn(3, 11).astype(np.float32)
        logits[1, 4] = logits[1, 7]  # a tie at a top-k boundary candidate
        return logits
    return (np.random.default_rng(0).standard_normal((2, 512)) * 3) \
        .astype(np.float32)


@pytest.mark.parametrize("top_k,top_p,kind", [
    pytest.param(k, p, kind, id=f"{k}-{p}") for k, p, kind in (
        (0, 0.0, "3x11"), (3, 0.0, "3x11"), (0, 0.7, "3x11"),
        (4, 0.9, "3x11"),
        # top_k above the vocabulary: the reference clamps the index and
        # masks nothing
        (12, 0.0, "3x11"),
        # top_p above any mass: the reference's cutoff index is V (a NaN
        # cutoff) and masks nothing
        (0, 1.5, "2x512"))])
def test_sampling_masks_equal_jax(monkeypatch, top_k, top_p, kind):
    """The logits the draw samples from — temperature-scaled, top-k and
    top-p masked — equal the reference's before the draw."""
    logits = _sampling_logits(kind)
    seen = {}

    def capture(rng, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jax.numpy.zeros(lg.shape[:-1], jax.numpy.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    sample_jax(jax.random.PRNGKey(0), jax.numpy.asarray(logits),
               temperature=0.8, top_k=top_k, top_p=top_p)
    mine = sampler.filter_logits(torch.from_numpy(logits), temperature=0.8,
                                 top_k=top_k, top_p=top_p).numpy()
    ref = seen["logits"]
    assert np.array_equal(np.isinf(mine), np.isinf(ref))
    if top_k >= logits.shape[-1] or top_p > 1.0:
        assert not np.isinf(mine).any()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(mine[fin], ref[fin], rtol=1e-6, atol=1e-6)


def test_sampling_top_p_one_keeps_rows_below_full_mass():
    """At top_p = 1.0 a row whose float32 cumsum ends below 1.0 has no
    cutoff inside the row: it keeps every logit instead of raising.  Which
    rows end below 1.0 depends on the summation order, so the rows are
    found with the port's own cumsum."""
    logits = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((200, 512)) * 3)
        .astype(np.float32))
    ordered = torch.sort(logits, dim=-1, descending=True).values
    short = torch.cumsum(torch.softmax(ordered, dim=-1), dim=-1)[:, -1] < 1.0
    assert short.any()
    mine = sampler.filter_logits(logits, temperature=1.0, top_p=1.0)
    assert torch.isfinite(mine[short]).all()
    torch.testing.assert_close(mine[short], logits[short], rtol=0, atol=0)


def test_sampling_frequencies_follow_softmax():
    """Draws from an explicit generator follow the softmax of the scaled
    logits: with n draws each frequency lies within 5 standard errors
    (sqrt(p(1-p)/n)) of its probability — a bound a correct sampler
    breaks with probability below 1e-5 per token."""
    logits = torch.tensor([[1.0, 0.5, -0.3, 2.0, 0.0, -1.0, 1.5, 0.2]])
    n, temp = 20000, 0.7
    gen = torch.Generator().manual_seed(0)
    toks = sampler.sample_tokens(logits.repeat(n, 1), temperature=temp,
                                 generator=gen)
    freq = torch.bincount(toks.long(), minlength=8).double() / n
    p = torch.softmax(logits[0].double() / temp, -1)
    assert ((freq - p).abs() <= 5 * (p * (1 - p) / n).sqrt()).all()
    # batched: greedy rows are argmax, stochastic rows follow the same law
    temps = torch.tensor([0.0, temp]).repeat(n // 2)
    both = sampler.sample_tokens_batched(
        logits.repeat(n, 1), temps, generator=torch.Generator().manual_seed(1))
    assert (both[0::2] == 3).all()
    freq2 = torch.bincount(both[1::2].long(), minlength=8).double() / (n // 2)
    assert ((freq2 - p).abs() <= 5 * (p * (1 - p) / (n // 2)).sqrt()).all()


def test_tokenizer_is_the_reference():
    a, b = ByteTokenizer(512), TokJax(512)
    for text in ("hello", "ünïcödé ✓", ""):
        assert a.encode(text) == b.encode(text)
        assert a.decode(a.encode(text)) == b.decode(b.encode(text)) == text
