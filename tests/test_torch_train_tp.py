"""The sharded train step (``make_train_step(model, optimizer, mesh)``)
on the CPU against the port's single-device step, which
``test_torch_train_parity.py`` holds to the reference; the state's
layout against the reference's ``train_state_pspecs``; and flash's
prefix form (the ``ulysses_sp`` shard's attention) against the
reference's masked attention.

Every mesh repeats the CPU device: one controller drives each
coordinate's program, so a mesh of any shape runs here.  Tolerances are
float32's: loss to 1e-6 relative, each coordinate's gradient of its
slices to 2e-5 of the leaf's largest entry (sums of the data rows'
partials in another order than one batch's product), and the updated
state (parameters and moments) to 1e-5 relative against AdamW run on
one device over the gathered gradients (comparing the states of the two
steps directly would measure AdamW's first step, which divides by the
gradient's own size and so turns last-bit differences of a gradient
near 0 into whole steps)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.launch import steps as steps_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro.models.attention import (  # noqa: E402
    mha_reference,
    prefix_causal_mask,
)
from repro.sharding import rules as rules_jax  # noqa: E402
from repro.training.optimizer import AdamW as AdamWJax  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.sharding.placement import (  # noqa: E402
    COLLECTIVES,
    NamedSharding,
    ShardedTensor,
)
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.tree import (  # noqa: E402
    flatten,
    tree_map,
    unflatten,
)

LR = 1e-4
LOSS_RTOL = 1e-6
GRAD_TOL = 2e-5
STATE_RTOL, STATE_ATOL = 1e-5, 1e-9

FAMILIES = {
    "dense": ("stablelm-3b", {}),
    "moe": ("olmoe-1b-7b", {}),
    "hybrid": ("recurrentgemma-9b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "vlm": ("pixtral-12b", {}),
    "encdec": ("whisper-medium", {}),
    "dense-ulysses": ("qwen3-14b", {"tp_strategy": "ulysses_sp",
                                    "remat": "full"}),
}
MESHES = [(2, 1), (1, 2), (2, 2), (2, 2, 1)]


def _mesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                             "model")
    n = int(np.prod(shape))
    return Mesh(np.array(["cpu"] * n, dtype=object).reshape(shape), axes)


def _batch(cfg, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                             .astype(np.int32))
         for k in ("tokens", "targets")}
    if cfg.frontend == "patch_stub":
        b["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, 4, cfg.d_model)).astype(np.float32))
    if cfg.family == "enc_dec":
        b["encoder_frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return b


def _global(st, grads, key):
    """A leaf's gradient assembled from the coordinates' slices, after
    checking that every replica of a slice holds the same."""
    shards = np.empty(st.mesh.devices.shape, dtype=object)
    for c in np.ndindex(shards.shape):
        shards[c] = grads[c][key]
    out = ShardedTensor(st.sharding, st.shape, torch.float32, shards).full()
    from repro_torch.sharding.placement import shard_slices
    for c in np.ndindex(shards.shape):
        torch.testing.assert_close(
            shards[c], out[shard_slices(st.shape, st.spec, st.mesh, c)],
            rtol=0, atol=0)
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_matches_single_device(family, shape):
    name, replace = FAMILIES[family]
    cfg = get_config(name).reduced().replace(**replace)
    model = build_model(cfg)
    opt = AdamW(learning_rate=LR)
    batch = _batch(cfg)
    mesh = _mesh(shape)
    rls = R.make_rules(mesh, cfg)
    if family == "dense-ulysses":
        assert rls.tp_strategy == "ulysses_sp"
    state = ST.init_train_state(model, opt, 0, device="cpu")
    placed = ST.place_train_state(model, opt, state, mesh)
    # the reference step under the same rules: MoE's shard_map dispatch
    # splits the tokens over the data axes as the sharded step does
    with R.use_rules(rls):
        loss1, _, g1 = ST.loss_and_grads(model, state["params"], batch)
    loss2, _, g2 = ST.mesh_loss_and_grads(
        model, rls, placed["params"], ST.row_batches(rls, batch))
    torch.testing.assert_close(loss2, loss1, rtol=LOSS_RTOL, atol=0)
    for key, st in flatten(placed["params"]).items():
        got = _global(st, g2, key)
        want = g1[key].float()
        scale = max(want.abs().max().item(), 1e-6)
        torch.testing.assert_close(got, want, rtol=0, atol=GRAD_TOL * scale,
                                   msg=key)
    # one whole sharded step; AdamW on one device over the gathered
    # gradients from copies of the same state gives the same state
    new2, m2 = ST.make_train_step(model, opt, mesh)(placed, batch)
    torch.testing.assert_close(m2["loss"], loss1, rtol=LOSS_RTOL, atol=0)
    flat_p = flatten(placed["params"])
    grads = unflatten(state["params"], {
        k: _global(st, g2, k) for k, st in flat_p.items()})
    ref = tree_map(lambda t: t.clone(), state)
    p_ref, o_ref, om = opt.update(grads, ref["opt"], ref["params"])
    torch.testing.assert_close(m2["grad_norm"], om["grad_norm"], rtol=1e-6,
                               atol=0)
    for tree, want in (("params", p_ref), ("mu", o_ref["mu"]),
                       ("nu", o_ref["nu"])):
        got = new2["params"] if tree == "params" else new2["opt"][tree]
        for key, st in flatten(got).items():
            torch.testing.assert_close(st.full(), flatten(want)[key],
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       msg=f"{tree} {key}")
    assert all(int(t) == 1 for t in new2["step"].shards.flat)
    assert all(int(t) == 1 for t in new2["opt"]["count"].shards.flat)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_sharded_step_accumulates_microbatches(shape):
    """``cfg.microbatches = 2``: the sharded step's loss and global
    gradient norm equal the single-device step's over the same two
    microbatches (each row's slice split in two), so the sum of the
    microbatches' gradients is divided by their count once."""
    cfg = get_config("stablelm-3b").reduced().replace(microbatches=2)
    model = build_model(cfg)
    opt = AdamW(learning_rate=LR)
    batch = _batch(cfg, B=8)
    mesh = _mesh(shape)
    rls = R.make_rules(mesh, cfg)
    state = ST.init_train_state(model, opt, 0, device="cpu")
    placed = ST.place_train_state(model, opt, state, mesh)
    # the single-device step over the microbatches the rows run: row i's
    # microbatch j is the j-th half of row i's slice
    rows = ST.row_batches(rls, batch)
    order = {k: torch.cat([torch.cat([r[k].reshape((2, -1) + r[k].shape[1:])
                                      [j] for r in rows]) for j in range(2)])
             for k in batch}
    _, m1 = ST.make_train_step(model, opt)(tree_map(lambda t: t.clone(),
                                                    state), order)
    _, m2 = ST.make_train_step(model, opt, mesh)(placed, batch)
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=LOSS_RTOL,
                               atol=0)
    torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5,
                               atol=0)


def test_collectives_counted_by_kind():
    """A (2, 2) step of the reduced dense model: every weight's FSDP
    gather is an all-gather and its backward a reduce-scatter; the
    residual's broadcasts to the shards are collective-permutes and the
    row-parallel sums all-reduces."""
    cfg = get_config("stablelm-3b").reduced()
    model = build_model(cfg)
    opt = AdamW(learning_rate=LR)
    mesh = _mesh((2, 2))
    placed = ST.place_train_state(
        model, opt, ST.init_train_state(model, opt, 0, device="cpu"), mesh)
    COLLECTIVES.reset()
    ST.make_train_step(model, opt, mesh)(placed, _batch(cfg))
    st = COLLECTIVES.snapshot()
    # every layer's leaf is gathered once a layer, every other leaf once
    # (each has a dim over data), and each gradient reduce-scattered once
    n = sum(cfg.num_layers if k.startswith("layers/") else 1
            for k in flatten(placed["params"]))
    assert st["all-gather"]["count"] == n
    assert st["reduce-scatter"]["count"] == n
    assert st["all-to-all"]["count"] == 0
    assert all(v["bytes"] > 0 for k, v in st.items() if k != "all-to-all")


class _FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


# the param strategies beside the default fsdp: ZeRO-2 replicates the
# weights over data and keeps the moments (and the master) in the FSDP
# layout
ZERO2 = ("zero2", "zero2_master")


@pytest.mark.parametrize("name,strategy", [
    pytest.param(n, "fsdp", id=n) for n in ARCH_IDS] + [
    pytest.param(n, z, id=f"{n}-{z}") for z in ZERO2 for n in ARCH_IDS])
def test_state_specs_equal_the_references(name, strategy):
    """``train_state_pspecs`` under the production meshes' shapes equals
    the reference's, leaf for leaf, under each param strategy (master
    weights under ``zero2_master``)."""
    master = strategy == "zero2_master"
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        mesh = _FakeMesh(shape, axes)
        cfg_t = get_config(name).replace(param_strategy=strategy)
        cfg_j = get_config_jax(name).replace(param_strategy=strategy)
        got = ST.train_state_pspecs(R.make_rules(mesh, cfg_t),
                                    build_model(cfg_t),
                                    AdamW(master_weights=master))
        want = steps_jax.train_state_pspecs(
            rules_jax.make_rules(mesh, cfg_j), build_jax(cfg_j),
            AdamWJax(master_weights=master))
        assert R.make_rules(mesh, cfg_t).tp_strategy == \
            rules_jax.make_rules(mesh, cfg_j).tp_strategy
        flat_w = _flat_specs(want)
        flat_g = _flat_specs(got)
        assert flat_g.keys() == flat_w.keys()
        for k, w in flat_w.items():
            assert tuple(flat_g[k]) == tuple(w), (name, shape, k)


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_specs(v, p))
        else:
            out[p] = v
    return out


@pytest.mark.parametrize("family", ["dense", "moe", "dense-ulysses"]
                         + [f"dense-{z}" for z in ZERO2])
def test_placed_state_specs_equal_the_references(family):
    """The placed state's leaves (reduced config, a (2, 2) mesh) carry
    the reference's specs under a fake mesh of that shape."""
    if family.startswith("dense-zero2"):
        name, replace = "stablelm-3b", {"param_strategy": family[6:]}
    else:
        name, replace = FAMILIES[family]
    master = replace.get("param_strategy") == "zero2_master"
    cfg = get_config(name).reduced().replace(**replace)
    model = build_model(cfg)
    opt = AdamW(master_weights=master)
    placed = ST.place_train_state(
        model, opt, ST.init_train_state(model, opt, 0, device="cpu"),
        _mesh((2, 2)))
    cfg_j = get_config_jax(name).reduced().replace(**replace)
    want = steps_jax.train_state_pspecs(
        rules_jax.make_rules(_FakeMesh((2, 2), ("data", "model")), cfg_j),
        build_jax(cfg_j), AdamWJax(master_weights=master))
    flat_w = _flat_specs(want)
    assert _flat_specs(placed).keys() == flat_w.keys()
    for key, st in _flat_specs(placed).items():
        assert tuple(st.spec) == tuple(flat_w[key]), key


@pytest.mark.parametrize("S,pad,plen", [(4, 8, 8), (6, 6, 6), (5, 8, 3)])
def test_flash_prefix_form_matches_the_references_mask(S, pad, plen):
    """Flash's prefix form (a ulysses_sp shard's queries, ``plen`` rows
    into the sequence) against the reference's ``mha_reference`` under
    ``prefix_causal_mask``; its gradient against autograd through the
    plain version."""
    rng = np.random.default_rng(S + pad)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((1, S, 4, 8), (1, pad + S, 2, 8), (1, pad + S, 2, 8)))
    k[:, plen:pad] = 0
    v[:, plen:pad] = 0
    want = np.asarray(mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=prefix_causal_mask(S, pad, plen)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa_ops.flash_attention(qt, kt, vt, prefix_pad=pad,
                                 prefix_len=plen)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, (qt, kt, vt), g)
    qs, ks, vs = (t.detach().requires_grad_() for t in (qt, kt, vt))
    ref = torch.autograd.grad(flash_attention_ref(
        qs, ks, vs, prefix_pad=pad, prefix_len=plen), (qs, ks, vs), g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_ulysses_rejects_a_sequence_that_does_not_split():
    """A ``ulysses_sp`` sequence the model axis does not divide (6 over 4
    shards) runs with every shard holding the row's whole sequence, as
    the reference's activation rule falls back, and the step holds to
    the one-device step."""
    cfg = get_config("qwen3-14b").reduced().replace(tp_strategy="ulysses_sp")
    rls = hold_sharded_step(cfg, (1, 4), _batch(cfg, S=6))
    assert rls.tp_strategy == "ulysses_sp"
    assert R.act_pspec(rls, "act_hidden", (4, 6, cfg.d_model))[1] is None


def _replicas_equal(st, what):
    """Every coordinate's local slice of ``st`` equals, bit for bit, every
    other coordinate's copy of that slice."""
    from repro_torch.sharding.placement import shard_slices
    first = {}
    for c in np.ndindex(st.mesh.devices.shape):
        key = tuple((s.start, s.stop) for s in shard_slices(
            st.shape, st.spec, st.mesh, c))
        t = st.local(c)
        if key in first:
            assert torch.equal(t, first[key]), (what, c)
        else:
            first[key] = t


def hold_sharded_step(cfg, shape, batch, *, steps=3):
    """The sharded step of ``cfg`` on a CPU mesh of ``shape`` against the
    port's one-device step (under the same rules, as the MoE dispatch
    reads them): the loss to ``LOSS_RTOL``, every coordinate's gradient
    of its slices to ``GRAD_TOL`` of the leaf's largest entry with every
    replica of a slice given the same gradient (``_global``), the state
    after one step against AdamW on one device over the gathered
    gradients (``STATE_RTOL``; the master copy too under
    ``zero2_master``), and after ``steps`` steps every replica of every
    leaf of the state bit-equal.  → the rules."""
    model = build_model(cfg)
    opt = AdamW(learning_rate=LR,
                master_weights=cfg.param_strategy == "zero2_master")
    mesh = _mesh(shape)
    rls = R.make_rules(mesh, cfg)
    state = ST.init_train_state(model, opt, 0, device="cpu")
    placed = ST.place_train_state(model, opt, state, mesh)
    with R.use_rules(rls):
        loss1, _, g1 = ST.loss_and_grads(model, state["params"], batch)
    loss2, _, g2 = ST.mesh_loss_and_grads(
        model, rls, placed["params"], ST.row_batches(rls, batch))
    torch.testing.assert_close(loss2, loss1, rtol=LOSS_RTOL, atol=0)
    flat_p = flatten(placed["params"])
    grads = {}
    for key, st in flat_p.items():
        grads[key] = got = _global(st, g2, key)
        want = g1[key].float()
        scale = max(want.abs().max().item(), 1e-6)
        torch.testing.assert_close(got, want, rtol=0, atol=GRAD_TOL * scale,
                                   msg=key)
    step = ST.make_train_step(model, opt, mesh)
    placed, m = step(placed, batch)
    torch.testing.assert_close(m["loss"], loss1, rtol=LOSS_RTOL, atol=0)
    ref = tree_map(lambda t: t.clone(), state)
    p_ref, o_ref, om = opt.update(unflatten(state["params"], grads),
                                  ref["opt"], ref["params"])
    torch.testing.assert_close(m["grad_norm"], om["grad_norm"], rtol=1e-6,
                               atol=0)
    trees = [("params", placed["params"], p_ref)] + [
        (n, placed["opt"][n], o_ref[n]) for n in ("mu", "nu", "master")
        if n in o_ref]
    for name, got, want in trees:
        for key, st in flatten(got).items():
            torch.testing.assert_close(st.full(), flatten(want)[key],
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       msg=f"{name} {key}")
    for _ in range(steps - 1):
        placed, m = step(placed, batch)
        assert torch.isfinite(m["loss"])
    for name, tree in [("params", placed["params"])] + [
            (n, t) for n, t in placed["opt"].items() if n != "count"]:
        for key, st in flatten(tree).items():
            _replicas_equal(st, f"{name} {key}")
    assert all(int(t) == steps for t in placed["step"].shards.flat)
    return rls


def test_named_sharding_of_a_placed_leaf():
    cfg = get_config("stablelm-3b").reduced()
    model = build_model(cfg)
    opt = AdamW()
    mesh = _mesh((2, 2))
    placed = ST.place_train_state(
        model, opt, ST.init_train_state(model, opt, 0, device="cpu"), mesh)
    st = placed["params"]["embed"]
    assert isinstance(st.sharding, NamedSharding)
    assert st.local((1, 1)).shape == (cfg.vocab_padded // 2,
                                      cfg.d_model // 2)
    # no two coordinates share a tensor: each takes its own update
    ids = {id(t) for t in placed["params"]["final_norm"]["scale"]
           .shards.flat}
    assert len(ids) == 4
