"""EngineFleet: scale the serving engine *out* to N routed replicas (the
port's copy of ``repro/serving/fleet.py``).

One ``ServingEngine`` scales up (continuous batching, paged KV).  The
fleet scales out: N engine replicas, each wrapped in a
``LocalEngineBackend`` and put behind one ``repro_torch.dispatch.Dispatcher``,
so PopPy's fan-out traffic spreads across replicas with no client-side
changes (the dispatcher *is* a ``Backend``).

Devices: with ``tp`` = 1 every replica runs on the one device the
engines are given, shares the caller's parameter tensors (the reference
copies parameters only per mesh) and issues its work on the same CUDA
stream from the same host thread, so the replicas' steps serialise; each
keeps its own slots, queue, page pool, radix prefix cache, decode graph
(with its own graph memory pool) and sampling generator.  With ``tp`` > 1
replica ``i`` spans a ``make_serving_mesh(tp)`` over the ``tp`` devices
starting at ``i * tp`` of ``devices`` (default: the host's CUDA
devices), or the first ``tp`` when there are fewer than ``replicas *
tp``; ``devices`` may repeat a device (``["cpu"] * 4``), and each replica
then holds its own shards of the parameters.  Every family the engine
shards may run so: dense, VLM and MoE on the paged layout, hybrid, SSM
and int8-KV models on the contiguous one.

Routing: the default ``prefix_affinity`` policy probes each replica's
radix prefix cache (``LocalEngineBackend.prefix_probe``) and sends a
request to the replica already holding the longest prefix of its prompt,
falling back to least-outstanding for cold traffic (DESIGN.md §3.4).
"""

from __future__ import annotations

import asyncio

from repro_torch.device import resolve_device
from repro_torch.dispatch import Dispatcher
from repro_torch.launch.mesh import host_devices, make_serving_mesh
from repro_torch.serving.backend import LocalEngineBackend
from repro_torch.serving.engine import ServingEngine


class EngineFleet:
    """N serving-engine replicas behind a prefix-affinity router.

    ``replicas`` engines are built from one ``(model, params)`` pair and
    share its parameter tensors (``tp`` = 1) or each place its own shards
    of them on its mesh over a slice of ``devices`` (``tp`` > 1; see the
    module docstring).  Remaining keyword arguments go to every
    ``ServingEngine`` (``device`` among them, default ``cuda``);
    ``dispatcher_kwargs`` (e.g. ``cache=``, ``hedge=``) go to the fleet's
    ``Dispatcher``.  Every replica samples from the engine's own seeded
    generator with the same seed, as the reference's replicas all start
    from ``PRNGKey(0)``.
    """

    def __init__(self, model, params, *, replicas: int = 1, tp: int = 1,
                 policy: str = "prefix_affinity", tokenizer=None,
                 hedge_timeout=None, dispatcher_kwargs: dict | None = None,
                 devices=None, **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if devices is None:
            devices = host_devices(
                resolve_device(engine_kwargs.get("device", "cuda")).type)
        devices = list(devices)
        if tp > len(devices):
            raise RuntimeError(
                f"tp={tp} needs {tp} devices, have {len(devices)}")
        self.replicas = replicas
        self.tp = tp
        self.names = [f"replica{i}" for i in range(replicas)]
        self.engines: list[ServingEngine] = []
        for i, name in enumerate(self.names):
            mesh = None
            if tp > 1:
                lo = i * tp
                sl = devices[lo:lo + tp] if lo + tp <= len(devices) \
                    else devices[:tp]
                mesh = make_serving_mesh(tp, devices=sl)
            self.engines.append(ServingEngine(model, params, mesh=mesh,
                                              name=name, **engine_kwargs))
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
