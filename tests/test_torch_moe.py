"""The port's MoE layer and MoE serving against the JAX package.

``apply_moe`` runs on one layer's expert parameters of reduced
``olmoe-1b-7b`` and ``qwen3-moe-30b-a3b`` (8 experts, top-2, float32),
made from a numpy seed and converted with ``convert.from_jax``, on the
same numpy inputs: at the
reduced configs' dropless capacity factor 8.0 and at 1.25, where
assignments drop and which ones drop depends on the queue order.  The
top-k indices must be equal, y within 1e-5 (XLA and PyTorch sum the
expert products in different orders) and the aux loss within 1e-6.

Then the port's paged engine serves a shared-prefix burst beside the JAX
paged engine on the same parameters (the port's seeded init, handed to
JAX: the reference's init seeds from ``hash(path)``, which changes per
process, and which assignments drop depends on the weights); greedy
tokens must be equal,
including at capacity factor 1.25 with 8 slots, where decode steps and
prefill chunks drop assignments.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from helpers_torch import build_pair  # noqa: E402
from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.models import moe as moe_jax  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
Y_TOL = 1e-5
AUX_TOL = 1e-6


def _configs(name, cf):
    return (get_config_jax(name).reduced().replace(moe_capacity_factor=cf),
            get_config(name).reduced().replace(moe_capacity_factor=cf))


def _moe_params(name, seed=7):
    """One MoE layer's parameters at the reduced shapes and the
    reference's init scales (1/sqrt(fan-in)), from a numpy seed."""
    cfg = get_config(name).reduced()
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    rng = np.random.RandomState(seed)
    shapes = {"router": ((D, E), D), "w_gate": ((E, D, Fd), D),
              "w_up": ((E, D, Fd), D), "w_down": ((E, Fd, D), Fd)}
    return {k: (rng.randn(*shp) / np.sqrt(fan)).astype(np.float32)
            for k, (shp, fan) in shapes.items()}


def _jax_topk(cfg, p, x):
    """The reference's routing (``repro/models/moe.py:70-73``)."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(xt @ jnp.asarray(p["router"], jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    return np.asarray(probs), np.asarray(idx)


def _moe_both(name, cf, p_np, x):
    """The MoE layer over ``x`` in both packages; the JAX side's top-k
    indices and router probabilities, and the port's top-k indices and
    keep mask, beside each side's y and aux loss."""
    cfg_j, cfg_t = _configs(name, cf)
    yj, auxj = moe_jax.apply_moe(
        cfg_j, {k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(x))
    probs_j, idx_j = _jax_topk(cfg_j, p_np, x)
    p_t = from_jax(cfg_t, p_np, device="cpu")
    xt = torch.tensor(x)
    with torch.no_grad():
        yt, auxt = moe.apply_moe(cfg_t, p_t, xt)
        _, _, idx_t = moe.route(cfg_t, p_t, xt.reshape(-1, x.shape[-1]))
    keep = moe.queue_positions(idx_t, cfg_t.num_experts) \
        < moe.expert_capacity(cfg_t, idx_t.shape[0])
    ref = dict(y=np.asarray(yj), aux=float(auxj), idx=idx_j, probs=probs_j)
    port = dict(y=yt.numpy(), aux=float(auxt), idx=idx_t.numpy(),
                keep=keep.numpy())
    return ref, port


def _assert_same(ref, port):
    assert np.array_equal(port["idx"], ref["idx"])
    np.testing.assert_allclose(port["y"], ref["y"], rtol=Y_TOL, atol=Y_TOL)
    assert abs(port["aux"] - ref["aux"]) <= AUX_TOL


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("name", ARCHS)
def test_apply_moe_matches_reference(name, cf):
    p_np = _moe_params(name)
    x = np.random.RandomState(11).randn(2, 12, 64).astype(np.float32)
    ref, port = _moe_both(name, cf, p_np, x)
    _assert_same(ref, port)
    # the drops the capacity bound makes: each expert keeps C assignments
    C = moe.expert_capacity(get_config(name).reduced().replace(
        moe_capacity_factor=cf), 24)
    load = np.bincount(ref["idx"].reshape(-1), minlength=8)
    dropped = int(np.maximum(load - C, 0).sum())
    assert int((~port["keep"]).sum()) == dropped
    if cf == 8.0:
        assert dropped == 0
    else:
        assert C == 7 and dropped > 0, (C, load)


def test_router_ties_go_to_the_lower_expert():
    """Two identical router columns (3 and 6) whose experts tie at the
    top-k boundary on every token: both frameworks keep expert 3, as
    ``lax.top_k`` breaks ties.  Inputs and weights are short binary
    fractions, so the router logits are exact and the tie is exact."""
    name = "olmoe-1b-7b"
    p_np = _moe_params(name)
    rng = np.random.RandomState(5)
    x = (rng.randint(1, 4, (2, 12, 64)) * 0.25).astype(np.float32)
    v = (rng.randint(0, 3, 64) / 64.0).astype(np.float32)
    router = np.zeros((64, 8), np.float32)
    router[:, 0] = 3 * v
    router[:, 3] = router[:, 6] = v
    router[:, 5] = -v
    p_np = {**p_np, "router": router}
    for cf in (8.0, 1.25):
        ref, port = _moe_both(name, cf, p_np, x)
        assert np.array_equal(ref["probs"][:, 3], ref["probs"][:, 6])
        assert (ref["idx"] == [0, 3]).all()
        _assert_same(ref, port)


@pytest.mark.parametrize("name", ARCHS)
def test_expert_capacity_is_the_reference_formula(name):
    """Capacity is a host int from the call's whole token count, never
    below K: full-width olmoe-1b-7b's decode at 8 slots is dropless, a
    256-token prefill chunk keeps 40 a expert for a mean load of 32."""
    for cfg in (get_config(name), get_config(name).reduced()):
        K, E = cfg.num_experts_per_tok, cfg.num_experts
        for cf in (1.25, 8.0):
            c = cfg.replace(moe_capacity_factor=cf)
            for n in (1, 8, 24, 256, 4096):
                assert moe.expert_capacity(c, n) \
                    == max(int(K * n * cf / E), K)
    olmoe = get_config("olmoe-1b-7b")
    assert moe.expert_capacity(olmoe, 8) == 8
    assert moe.expert_capacity(olmoe, 256) == 40


# ---------------------------------------------------------------------------
# the paged engines on reduced MoE models

PREFIX = list(range(40, 72))   # page-aligned 32-token shared prefix


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [PREFIX + [int(t) for t in rng.randint(1, 500, 3 + 5 * i)]
            for i in range(n)]


async def _serve(engine, prompts, max_new):
    await engine.warm_prefix(PREFIX)
    outs = await asyncio.gather(*[
        engine.generate(p, max_new_tokens=max_new) for p in prompts])
    await engine.stop()
    return outs


@pytest.mark.parametrize("name,cf,slots", [("olmoe-1b-7b", 8.0, 4),
                                           ("qwen3-moe-30b-a3b", 1.25, 8)])
def test_paged_engine_tokens_equal_jax_engine(monkeypatch, name, cf, slots):
    """Greedy tokens equal over a warmed shared prefix, with chunked
    prefill; at 1.25 the port's decode steps (N = 8 slots, idle slots
    included) and prefill chunks both drop assignments."""
    drops = []
    apply = moe.apply_moe

    def counted(cfg, p, x):
        _, _, idx = moe.route(cfg, p, x.reshape(-1, x.shape[-1]))
        keep = moe.queue_positions(idx, cfg.num_experts) \
            < moe.expert_capacity(cfg, idx.shape[0])
        drops.append((idx.shape[0], int((~keep).sum())))
        return apply(cfg, p, x)
    monkeypatch.setattr(moe, "apply_moe", counted)
    cfg_t, mj, params_j, mt, params_t = build_pair(
        name, moe_capacity_factor=cf)
    kw = dict(max_slots=slots, max_len=96, page_size=16, prefill_chunk=16)
    prompts = _prompts(1, 6)
    ej = JaxEngine(mj, params_j, **kw)
    et = ServingEngine(mt, params_t, device="cpu", **kw)
    assert et.kv_layout == "paged"
    want = asyncio.run(_serve(ej, prompts, 8))
    got = asyncio.run(_serve(et, prompts, 8))
    assert got == want
    st = et.stats()
    assert st["kv_admit_copies"] == 0
    assert st["prefill_tokens_reused"] == ej.prefill_tokens_reused > 0
    assert et.prefill_chunks == ej.prefill_chunks
    assert max(et.batch_occupancy) >= 2
    decode = [d for n, d in drops if n == slots]
    prefill = [d for n, d in drops if n != slots]
    assert len(decode) == et.steps * cfg_t.num_layers and prefill
    if cf == 8.0:
        assert not any(decode) and not any(prefill)
    else:
        assert any(decode) and any(prefill), drops


def test_contiguous_opt_out_tokens_equal_jax_engine():
    """An MoE model may opt into the contiguous layout, as a dense one
    may: greedy tokens equal the JAX engine's opt-out, one KV splice per
    admission."""
    cfg_t, mj, params_j, mt, params_t = build_pair("olmoe-1b-7b")
    kw = dict(max_slots=4, max_len=96, kv_layout="contiguous")
    prompts = _prompts(2, 3)
    want = asyncio.run(_serve(JaxEngine(mj, params_j, **kw), prompts, 6))
    et = ServingEngine(mt, params_t, device="cpu", **kw)
    assert asyncio.run(_serve(et, prompts, 6)) == want
    assert et.stats()["kv_admit_copies"] == len(prompts)
