"""EngineFleet: scale the serving engine *out* to N routed replicas (the
port's copy of ``repro/serving/fleet.py``).

One ``ServingEngine`` scales up (continuous batching, paged KV).  The
fleet scales out: N engine replicas, each wrapped in a
``LocalEngineBackend`` and put behind one ``repro_torch.dispatch.Dispatcher``,
so PopPy's fan-out traffic spreads across replicas with no client-side
changes (the dispatcher *is* a ``Backend``).

Devices: the fleet counts ``torch.cuda.device_count()`` devices on
``cuda`` and one on ``cpu``.  Every replica runs on the one device the
engines are given, shares the caller's parameter tensors (the reference
copies parameters only per mesh) and issues its work on the same CUDA
stream from the same host thread, so the replicas' steps serialise; each
keeps its own slots, queue, page pool, radix prefix cache, decode graph
(with its own graph memory pool) and sampling generator.  ``tp`` > 1
(a replica over a tensor-parallel mesh) is not ported yet.

Routing: the default ``prefix_affinity`` policy probes each replica's
radix prefix cache (``LocalEngineBackend.prefix_probe``) and sends a
request to the replica already holding the longest prefix of its prompt,
falling back to least-outstanding for cold traffic (DESIGN.md §3.4).
"""

from __future__ import annotations

import asyncio

import torch

from repro_torch.device import resolve_device
from repro_torch.dispatch import Dispatcher
from repro_torch.serving.backend import LocalEngineBackend
from repro_torch.serving.engine import ServingEngine


def device_count(device) -> int:
    """Devices a fleet on ``device`` may place replicas over."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


class EngineFleet:
    """N serving-engine replicas behind a prefix-affinity router.

    ``replicas`` engines are built from one ``(model, params)`` pair and
    share its parameter tensors.  Remaining keyword arguments go to every
    ``ServingEngine`` (``device`` among them, default ``cuda``);
    ``dispatcher_kwargs`` (e.g. ``cache=``, ``hedge=``) go to the fleet's
    ``Dispatcher``.  Every replica samples from the engine's own seeded
    generator with the same seed, as the reference's replicas all start
    from ``PRNGKey(0)``.
    """

    def __init__(self, model, params, *, replicas: int = 1, tp: int = 1,
                 policy: str = "prefix_affinity", tokenizer=None,
                 hedge_timeout=None, dispatcher_kwargs: dict | None = None,
                 **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        n_devices = device_count(
            resolve_device(engine_kwargs.get("device", "cuda")))
        if tp > n_devices:
            raise RuntimeError(
                f"tp={tp} needs {tp} devices, have {n_devices}")
        if tp > 1:
            raise NotImplementedError(
                f"tp={tp}: tensor-parallel replicas wait for ROADMAP.md "
                f"§A.11")
        self.replicas = replicas
        self.tp = tp
        self.names = [f"replica{i}" for i in range(replicas)]
        self.engines: list[ServingEngine] = [
            ServingEngine(model, params, name=name, **engine_kwargs)
            for name in self.names]
        self.backends = [
            LocalEngineBackend(e, tokenizer, hedge_timeout=hedge_timeout)
            for e in self.engines]
        self.dispatcher = Dispatcher(
            self.backends, policy=policy, names=self.names,
            **(dispatcher_kwargs or {}))

    @property
    def stats(self):
        """The fleet dispatcher's ``DispatchStats`` — per-replica routed /
        prefix-hit counters live under ``snapshot()["backends"]``."""
        return self.dispatcher.stats

    def engine_stats(self) -> dict:
        return {name: e.stats()
                for name, e in zip(self.names, self.engines)}

    async def stop(self):
        await asyncio.gather(*(e.stop() for e in self.engines))
