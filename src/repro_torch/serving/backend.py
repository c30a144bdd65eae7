"""LLM backend bridging PopPy's AI component library to the port's
serving engine (the port's copy of ``repro/serving/backend.py``):
`@unordered` llm() calls become engine requests that share
continuous-batching decode steps.  Includes hedged-request straggler
mitigation and shared-prefix admission: an app-level batch (PopPy's
fan-out, DESIGN.md §2.3) warms the engine's radix KV cache with the
batch's common prompt prefix once, so every element prefills only its
suffix (DESIGN.md §3.2).  The batch's shared-prefix counters land on
``repro_torch.core.ai.ambient_dispatch_stats()``: the port dispatcher that
routed the call binds itself there around it."""

from __future__ import annotations

import asyncio

from repro_torch.core.ai import Backend, ambient_dispatch_stats
from repro_torch.obs.spans import maybe_span
from repro_torch.serving.tokenizer import ByteTokenizer


def common_prefix_len(token_lists) -> int:
    """Length of the longest token prefix shared by every list."""
    if not token_lists:
        return 0
    first, n = token_lists[0], min(len(t) for t in token_lists)
    for toks in token_lists[1:]:
        i = 0
        while i < n and toks[i] == first[i]:
            i += 1
        n = i
        if n == 0:
            break
    return n


class LocalEngineBackend(Backend):
    def __init__(self, engine, tokenizer=None, *, hedge_timeout=None,
                 warm_shared_prefix=True, min_shared_prefix=4,
                 faults=None, name="local"):
        self.engine = engine
        self.tok = tokenizer or ByteTokenizer(engine.cfg.vocab_size)
        self.hedge_timeout = hedge_timeout
        self.warm_shared_prefix = warm_shared_prefix
        self.min_shared_prefix = min_shared_prefix
        self.hedges = 0
        self.name = name
        # chaos testing (repro_torch.durability.faults): perturb each request
        # *before* it touches the engine, so an injected failure never
        # leaks a decode slot or prefix pin
        from repro_torch.durability.faults import make_injector
        self.faults = make_injector(faults)

    def prefix_probe(self, prompt: str) -> int:
        """Longest-cached-prefix token count for ``prompt`` — the routing
        digest consulted by ``dispatch``'s prefix-affinity policy.  A
        read-only radix-trie walk (no pins, no stat mutation); returns 0
        when the engine runs without a prefix cache."""
        return self.engine.prefix_probe(self.tok.encode(prompt))

    async def generate(self, prompt, *, max_tokens, temperature, stop):
        if self.faults is not None:
            await self.faults.perturb(self.name)
        return await self._generate_tokens(
            self.tok.encode(prompt), max_tokens=max_tokens,
            temperature=temperature)

    async def _generate_tokens(self, toks, *, max_tokens, temperature):
        coro = self.engine.generate(toks, max_new_tokens=max_tokens,
                                    temperature=temperature)
        if self.hedge_timeout is None:
            out = await coro
        else:
            # straggler mitigation: if the request exceeds the hedge
            # deadline, race a duplicate (deterministic decode → same
            # answer, whichever engine slot finishes first wins).  Losing
            # or abandoned tasks are cancelled — the engine drops a
            # cancelled request's slot at its next step, so a duplicate
            # never keeps decoding to max_new_tokens in the dark.
            task = asyncio.ensure_future(coro)
            try:
                out = await asyncio.wait_for(asyncio.shield(task),
                                             self.hedge_timeout)
            except asyncio.TimeoutError:
                self.hedges += 1
                task2 = asyncio.ensure_future(self.engine.generate(
                    toks, max_new_tokens=max_tokens,
                    temperature=temperature))
                try:
                    done, pending = await asyncio.wait(
                        {task, task2}, return_when=asyncio.FIRST_COMPLETED)
                    # prefer a success if both finished in the same tick;
                    # re-raise only when every finished racer failed
                    result, error = None, None
                    for t in done:
                        try:
                            result = t.result()
                            error = None
                            break
                        except BaseException as e:
                            error = error or e
                    if error is not None:
                        raise error
                    out = result
                finally:
                    # always reap the racers — a raced-or-abandoned
                    # duplicate must not keep its engine slot decoding
                    task.cancel()
                    task2.cancel()
            except asyncio.CancelledError:
                # the client abandoned the request (e.g. a dispatch-layer
                # hedge lost): without this, shield() leaves the engine
                # decoding a result nobody will read
                task.cancel()
                raise
        with maybe_span("detokenize", cat="serving.detok", n=len(out)):
            return self.tok.decode(out)

    async def embed(self, text):
        if self.faults is not None:
            await self.faults.perturb(self.name)
        toks = self.tok.encode(text)[:8]
        return tuple(float(t) / self.tok.vocab_size for t in toks)

    # -- list payloads (PopPy auto-batching, DESIGN.md §2.3) ----------------
    # An app-level batch becomes one admission burst into the
    # continuous-batching engine: every element is submitted in the same
    # loop pass, so the scheduler admits them into shared decode steps
    # (free slots permitting) instead of trickling them in one at a time.
    # Before the burst, the batch's common token prefix (PopPy fan-outs
    # share long system/context prefixes) is prefilled into the radix
    # cache exactly once; per-batch prefix-hit stats land on the ambient
    # dispatcher's DispatchStats.  Hedging is per element — a straggling
    # slot re-races alone.

    async def generate_batch(self, prompts, *, max_tokens, temperature,
                             stop):
        toks = [self.tok.encode(p) for p in prompts]
        await self._warm_common_prefix(toks)
        return list(await asyncio.gather(
            *(self._generate_tokens(t, max_tokens=max_tokens,
                                    temperature=temperature)
              for t in toks),
            return_exceptions=True))

    async def _warm_common_prefix(self, toks):
        if not self.warm_shared_prefix or len(toks) < 2:
            return
        shared = common_prefix_len(toks)
        if shared < self.min_shared_prefix:
            return
        warmed = await self.engine.warm_prefix(toks[0][:shared])
        if warmed is not None:
            ambient_dispatch_stats().note_prefix_batch(
                elements=len(toks), shared_tokens=warmed["tokens"],
                computed_tokens=warmed["computed"])

    async def embed_batch(self, texts):
        return list(await asyncio.gather(
            *(self.embed(t) for t in texts), return_exceptions=True))
