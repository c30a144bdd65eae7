"""The paged radix trie keys a node's children by the first *page* of
their edge (ROADMAP C.5, repaired in the port): fig15's four session
prefixes, which share BOS and the first nine characters, coexist as
siblings.  The reference trie keys children by the first token, so a
prompt that diverges inside the first page replaces its sibling; its
behaviour on the same inputs is recorded here (ROADMAP §D)."""

import asyncio

import pytest
import torch

import repro.serving.engine as engine_ref
import repro.serving.prefix_cache as trie_ref
import repro_torch.serving.engine as engine_port
import repro_torch.serving.prefix_cache as trie_port
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.tokenizer import ByteTokenizer

PS = 16
SESSIONS = 4
PREFIX_CHARS = 160


def session_prefix(s):
    """fig15's per-session prefix (``benchmarks/fig15_fleet.py``)."""
    base = (f"Session {s:02d} memory: the user is planning trip {s}, "
            f"prefers rail over air, budget tier {s % 3}. Context: ")
    out = base
    while len(out) < PREFIX_CHARS:
        out += base
    return out[:PREFIX_CHARS]


def _prompts(vocab):
    tok = ByteTokenizer(vocab)
    return [tok.encode(session_prefix(s) + "Q00: next")
            for s in range(SESSIONS)]


def _insert_all(pkg_trie, pkg_engine, prompts):
    alloc = pkg_engine.PageAllocator(64, PS)
    trie = pkg_trie.PagedPrefixCache(alloc, budget_pages=64)
    for p in prompts:
        n = (len(p) // PS) * PS
        ids = alloc.alloc(n // PS)
        trie.insert(p[:n], ids)
        alloc.decref(ids)     # the trie's refs keep the pages
    return alloc, trie


def _node_pages(trie):
    n, stack = 0, list(trie.root.children.values())
    while stack:
        nd = stack.pop()
        n += len(nd.pages)
        stack.extend(nd.children.values())
    return n


def test_reference_trie_loses_siblings_in_the_first_page():
    alloc, trie = _insert_all(trie_ref, engine_ref, _prompts(512))
    assert [trie.probe(p) for p in _prompts(512)] == [0, 0, 0, 160]
    # the replaced nodes' pages stay referenced out of eviction's reach
    assert trie.pages == 4 * 10 and _node_pages(trie) == 10
    trie.drop_unpinned()
    assert alloc.free_count == 64 - 30


def test_port_trie_keeps_siblings():
    alloc, trie = _insert_all(trie_port, engine_port, _prompts(512))
    assert [trie.probe(p) for p in _prompts(512)] == [160] * 4
    assert trie.pages == _node_pages(trie) == 4 * 10
    # a partial match inside a first page is a miss; a whole page is not
    p0 = _prompts(512)[0]
    assert trie.match_and_pin(p0[:PS - 1] + [7] * 20)[0] == 0
    m, pages, handle = trie.match_and_pin(p0[:PS] + [7] * 20)
    assert m == PS and len(pages) == 1
    trie.release(handle)
    assert trie.pages == _node_pages(trie) == 4 * 10
    trie.drop_unpinned()
    assert trie.pages == 0 and alloc.free_count == 64


def test_port_engine_holds_every_session():
    """The four prefixes primed into one engine: each probes 160, the
    trie's pages are its nodes' pages, and dropping the unpinned prefixes
    returns every page to the allocator."""
    cfg = get_config("stablelm-3b").reduced()
    model = build_model(cfg)
    eng = engine_port.ServingEngine(model, model.init(0, device="cpu"),
                                    max_slots=4, max_len=256, page_size=PS,
                                    device="cpu")
    prompts = _prompts(cfg.vocab_size)

    async def prime():
        for p in prompts:
            await eng.generate(p, max_new_tokens=2)
        await eng.stop()
    torch.set_num_threads(1)
    asyncio.run(prime())
    trie = eng.prefix_cache
    assert [eng.prefix_probe(p) for p in prompts] == [160] * SESSIONS
    assert trie.pages == _node_pages(trie) == SESSIONS * 160 // PS
    eng.reset_prefix_cache()
    assert trie.pages == 0
    assert eng.allocator.free_count == eng.num_pages


@pytest.mark.parametrize("page_size", [8, 16, 32])
def test_port_trie_split_and_release_by_page(page_size):
    """Two prompts sharing two pages then diverging: the split node is
    keyed by its first page, pins release along page keys, and eviction
    reaches every node."""
    alloc = engine_port.PageAllocator(32, page_size)
    trie = trie_port.PagedPrefixCache(alloc, budget_pages=32)
    a = list(range(1, 1 + 4 * page_size))
    b = a[:2 * page_size] + [999] * (2 * page_size)
    for p in (a, b):
        ids = alloc.alloc(4)
        trie.insert(p, ids)
        alloc.decref(ids)
    assert trie.splits == 1 and trie.pages == 6
    m, pages, handle = trie.match_and_pin(b)
    assert m == 4 * page_size and len(pages) == 4
    trie.drop_unpinned()
    assert trie.pages == 4        # the pinned path stays
    trie.release(handle)
    trie.drop_unpinned()
    assert trie.pages == 0 and alloc.free_count == 32
