"""The sharded train step and the dry-run's sharded prefill and decode
steps under every strategy and state layout the reference's
``make_rules`` and ``make_train_step`` lower: ``ulysses_sp`` over MoE,
hybrid, SSM, VLM and encoder-decoder blocks, the ``ulysses`` and
``heads_sp`` strategies, ZeRO-2 and ``zero2_master``, and sequences the
model axis does not divide; plus flash's windowed prefix form against
the reference's window mask.

Every mesh repeats the CPU device.  The train cases are held by
``test_torch_train_tp.hold_sharded_step`` against the port's one-device
step (which ``test_torch_train_parity.py`` holds to the reference): loss
to 1e-6 relative, each coordinate's gradient to 2e-5 of the leaf's
largest entry, every replica of a slice given the same gradient, the
state after one step, and every replica bit-equal after three steps.
The serving steps' logits are held to the one-device model's at 1e-5
(float32)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models.attention import causal_mask, mha_reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
    keep_mask,
)
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import build_model, lm  # noqa: E402
from repro_torch.models import moe as moemod  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.sharding.placement import COLLECTIVES  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from test_torch_train_tp import (  # noqa: E402
    LR,
    _batch,
    _mesh,
    hold_sharded_step,
)

TOL = 1e-5

# name -> (arch, config changes, mesh, batch kwargs, the strategy the
# rules pick)
CASES = {
    # the encoder's 24 frames and the decoder's 12 positions split three
    # ways: encoder rows attend every gathered key, decoder rows the whole
    # memory
    "encdec_split": ("whisper-medium", dict(enc_seq=24), (1, 3),
                     dict(S=12), "ulysses_sp"),
    "encdec_ulysses_sp_2x2": ("whisper-medium",
                              dict(tp_strategy="ulysses_sp"), (2, 2), {},
                              "ulysses_sp"),
    "encdec_ulysses": ("whisper-medium", dict(tp_strategy="ulysses"),
                       (1, 2), {}, "ulysses"),
    "encdec_heads_sp": ("whisper-medium", dict(tp_strategy="heads_sp"),
                        (2, 2), {}, "heads_sp"),
    "moe_heads_sp": ("olmoe-1b-7b", dict(tp_strategy="heads_sp"), (2, 2),
                     {}, "heads_sp"),
    "moe_ulysses": ("olmoe-1b-7b", dict(tp_strategy="ulysses"), (2, 2), {},
                    "ulysses"),
    "hybrid_ulysses": ("recurrentgemma-9b",
                       dict(tp_strategy="ulysses", attn_window=4), (1, 3),
                       dict(S=12), "ulysses"),
    "hybrid_heads_sp": ("recurrentgemma-9b",
                        dict(tp_strategy="heads_sp", attn_window=4), (1, 2),
                        dict(S=12), "heads_sp"),
    "hybrid_ulysses_sp_2x3": ("recurrentgemma-9b", dict(attn_window=5),
                              (2, 3), dict(S=12), "ulysses_sp"),
    "ssm_ulysses_sp": ("mamba2-2.7b", dict(tp_strategy="ulysses_sp"),
                       (1, 2), {}, "ulysses_sp"),
    "vlm_ulysses_sp": ("pixtral-12b", dict(tp_strategy="ulysses_sp"),
                       (2, 2), {}, "ulysses_sp"),
    # q heads of 12 over 4 KV heads, three shards: heads_sp's attention
    # cut from the gathered weights reads its KV heads in unequal groups
    "gqa_heads_sp": ("qwen3-14b", dict(tp_strategy="heads_sp",
                                       num_heads=12, num_kv_heads=4),
                     (1, 3), dict(S=12), "heads_sp"),
    "heads_sp_seq_whole": ("stablelm-3b", dict(tp_strategy="heads_sp"),
                           (1, 4), dict(S=6), "heads_sp"),
    "ulysses_pod": ("stablelm-3b", dict(tp_strategy="ulysses"), (2, 1, 2),
                    {}, "ulysses"),
    "zero2_2x2": ("stablelm-3b", dict(param_strategy="zero2"), (2, 2), {},
                  "heads"),
    "zero2_pod": ("stablelm-3b", dict(param_strategy="zero2"), (2, 2, 1),
                  {}, "heads"),
    "zero2_master_2x2": ("stablelm-3b", dict(param_strategy="zero2_master"),
                         (2, 2), {}, "heads"),
    "zero2_master_moe": ("olmoe-1b-7b", dict(param_strategy="zero2_master"),
                         (2, 2), {}, "heads"),
    "zero2_microbatches": ("stablelm-3b", dict(param_strategy="zero2",
                                               microbatches=2), (2, 2),
                           dict(B=8), "heads"),
    "zero2_ulysses_sp": ("qwen3-14b", dict(param_strategy="zero2",
                                           tp_strategy="ulysses_sp"),
                         (2, 2), {}, "ulysses_sp"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_layout_matches_single_device(name):
    arch, rep, shape, bkw, strategy = CASES[name]
    cfg = get_config(arch).reduced().replace(**rep)
    rls = hold_sharded_step(cfg, shape, _batch(cfg, **bkw))
    assert rls.tp_strategy == strategy


def test_moe_ulysses_sp_routes_the_rows_whole_token_set():
    """``ulysses_sp`` MoE at a capacity factor of 0.5 with the port's
    seeded weights, under which the capacity drops assignments: the
    sharded step routes over the row's whole token set, as the
    reference's dispatch counts capacity, and holds to the one-device
    step; routing each shard's rows on their own drops other tokens."""
    cfg = get_config("olmoe-1b-7b").reduced().replace(
        tp_strategy="ulysses_sp", moe_capacity_factor=0.5)
    batch = _batch(cfg, B=2, S=16)
    params = build_model(cfg).init(0, device="cpu")
    p = lm.unstack(params["layers"], cfg.num_layers)[0]["b0"]["moe"]
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    _, _, idx = moemod.route(cfg, p, x.reshape(-1, cfg.d_model))
    N = x.shape[0] * x.shape[1]
    C = moemod.expert_capacity(cfg, N)
    assert (moemod.queue_positions(idx, cfg.num_experts) >= C).any()
    whole = moemod.apply_moe_global(cfg, p, x)[0]
    halves = torch.cat([moemod.apply_moe_global(cfg, p, h)[0]
                        for h in x.split(8, dim=1)], dim=1)
    assert not torch.allclose(whole, halves, atol=1e-3)
    rls = hold_sharded_step(cfg, (1, 2), batch)
    assert rls.tp_strategy == "ulysses_sp"


@pytest.mark.parametrize("shape,S,window", [((1, 3), 12, 4),
                                            ((1, 2), 16, 6)])
def test_hybrid_window_crosses_a_shard_boundary(shape, S, window):
    """recurrentgemma's local attention under ``ulysses_sp`` with a window
    shorter than the sequence: a shard's first rows keep the window's
    keys on the shard before it (flash's windowed prefix form) and drop
    the older ones; the RG-LRU blocks run on the gathered rows."""
    cfg = get_config("recurrentgemma-9b").reduced().replace(
        attn_window=window, tp_strategy="ulysses_sp")
    tp = shape[1]
    Sl = S // tp
    # shard 1's first row keeps the newest keys of shard 0, not the oldest
    keep = keep_mask(Sl, S, causal=True, window=window, prefix_pad=Sl,
                     prefix_len=Sl)
    assert keep[0, :Sl].any() and not keep[0, :Sl].all()
    rls = hold_sharded_step(cfg, shape, _batch(cfg, S=S))
    assert rls.tp_strategy == "ulysses_sp"


@pytest.mark.parametrize("Sl,T,off,window", [
    (4, 12, 8, 4), (4, 12, 4, 6), (8, 16, 8, 3), (5, 15, 10, 11),
    (6, 6, 0, 2), (4, 12, 8, 0)])
def test_flash_windowed_prefix_form_matches_the_references_mask(
        Sl, T, off, window):
    """Flash's prefix form with a window (shard r's query rows ``[off,
    off + Sl)`` over all T keys, ``prefix_pad = prefix_len = off``)
    against the reference's ``mha_reference`` under its ``causal_mask``
    at that offset and window (f32, 2e-5); ``kept_pairs`` counts the same
    mask; the autograd Function's recompute backward uses it too."""
    rng = np.random.default_rng(Sl + T + off + window)
    q = rng.standard_normal((2, Sl, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, T, 2, 8)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window, prefix_pad=off, prefix_len=off)
    ref_mask = np.asarray(causal_mask(Sl, T, offset=off, window=window))
    want = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v),
                                    mask=jnp.asarray(ref_mask)))
    mask = keep_mask(Sl, T, **kw)
    np.testing.assert_array_equal(mask.numpy(), ref_mask[0, 0])
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa_ops.flash_attention(qt, kt, vt, **kw)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    pairs, rows = fa_ops.kept_pairs(Sl, T, **kw)
    assert pairs == int(mask.sum())
    kept_rows = mask.any(0).nonzero()[:, 0]
    assert rows == int(kept_rows.max() - kept_rows.min() + 1)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(out, (qt, kt, vt), g)
    qs, ks, vs = (t.detach().requires_grad_() for t in (qt, kt, vt))
    ref = torch.autograd.grad(flash_attention_ref(qs, ks, vs, **kw),
                              (qs, ks, vs), g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_zero2_gathers_the_updated_parameters():
    """ZeRO-2 on (2, 1): the gradients arrive all-reduced over data, each
    data replica updates its half of the moments and of the parameters,
    and one all-gather a leaf split in the moments' layout hands each
    replica the other half."""
    cfg = get_config("stablelm-3b").reduced().replace(param_strategy="zero2")
    model = build_model(cfg)
    opt = AdamW(learning_rate=LR)
    mesh = _mesh((2, 1))
    placed = ST.place_train_state(
        model, opt, ST.init_train_state(model, opt, 0, device="cpu"), mesh)
    split = [k for k, st in ST.flatten(placed["opt"]["mu"]).items()
             if "data" in str(st.spec)]
    assert split
    rls = R.make_rules(mesh, cfg)
    COLLECTIVES.reset()
    ST.mesh_loss_and_grads(model, rls, placed["params"],
                           ST.row_batches(rls, _batch(cfg)))
    grads = COLLECTIVES.snapshot()
    assert grads["reduce-scatter"]["count"] == 0
    assert grads["all-reduce"]["count"] > 0
    COLLECTIVES.reset()
    ST.make_train_step(model, opt, mesh)(placed, _batch(cfg))
    st = COLLECTIVES.snapshot()
    assert st["all-gather"]["count"] - grads["all-gather"]["count"] \
        == len(split)


# -- the dry-run's sharded prefill and decode steps ---------------------------

# name -> (arch, config changes, mesh, prompt length)
SERVE_CASES = {
    "dense_ulysses": ("stablelm-3b", dict(tp_strategy="ulysses"), (1, 2), 6),
    "dense_heads_sp": ("stablelm-3b", dict(tp_strategy="heads_sp"), (1, 2),
                       6),
    "gqa_heads_sp": ("qwen3-14b", dict(tp_strategy="heads_sp",
                                       num_heads=12, num_kv_heads=4),
                     (1, 3), 6),
    "moe_ulysses_sp": ("olmoe-1b-7b", dict(tp_strategy="ulysses_sp"),
                       (1, 2), 6),
    "hybrid_ulysses_sp": ("recurrentgemma-9b", dict(attn_window=4), (1, 3),
                          9),
    "ssm_ulysses_sp": ("mamba2-2.7b", dict(tp_strategy="ulysses_sp"),
                       (1, 2), 6),
    "encdec_ulysses_sp": ("whisper-medium", dict(tp_strategy="ulysses_sp"),
                          (1, 2), 6),
    "encdec_heads_sp": ("whisper-medium", dict(tp_strategy="heads_sp"),
                        (1, 2), 6),
}


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_prefill_and_decode_steps_match_one_device(name):
    """``make_prefill_step`` and ``make_decode_step`` of a mesh under the
    case's strategy: the prefill's last logits against the one-device
    ``prefill``; then three decode steps over the one-device prefill's
    cache placed by the rules (contiguous models and whisper) or over a
    zeroed cache (dense and MoE), logits against the one-device
    ``decode_step``, and the placed cache against the one-device cache
    after them (1e-5)."""
    arch, rep, shape, S = SERVE_CASES[name]
    cfg = get_config(arch).reduced().replace(**rep)
    model = build_model(cfg)
    rls = R.make_rules(_mesh(shape), cfg)
    params = model.init(seed=0, device="cpu")
    B, cap = 2, 16
    batch = {k: v for k, v in _batch(cfg, B=B, S=S).items()
             if k != "targets"}
    placed_params = ST.place_params(model, rls, params)
    got = ST.make_prefill_step(model, rls, cap)(
        placed_params, ST.place_batch(rls, batch, share=False))
    want, cache = model.prefill(params, batch, cap)
    torch.testing.assert_close(got[0][0], want, rtol=TOL, atol=TOL)
    if not (lm.is_contiguous(cfg) or model.is_encdec):
        cache, S = model.init_cache(B, cap, device="cpu"), 0
    placed = ST.place_cache(rls, cache)
    step = ST.make_decode_step(model, rls, cap)
    rng = np.random.RandomState(5)
    for t in range(3):
        tok = torch.as_tensor(rng.randint(1, cfg.vocab_size, (B, 1)),
                              dtype=torch.int32)
        pos = torch.full((B,), S + t, dtype=torch.int32)
        want, cache = model.decode_step(params, cache, tok, pos)
        got = step(placed_params, placed, tok, pos)
        torch.testing.assert_close(got[0], want, rtol=TOL, atol=TOL)
    for path, st in ST.flatten(placed).items():
        torch.testing.assert_close(st.full(), ST.flatten(cache)[path],
                                   rtol=TOL, atol=TOL, msg=path)


# -- the dry-run's cells in these layouts -------------------------------------

# (arch, kind, mesh, config changes, the strategy make_rules picks): reduced
# configs at vocab 512 on meta tensors, 4 heads over a model axis of 3 giving
# ulysses_sp for every family but the SSM
DRYRUN_CELLS = [
    ("olmoe-1b-7b", "train", (2, 3), {}, "ulysses_sp"),
    ("recurrentgemma-9b", "train", (2, 3), {}, "ulysses_sp"),
    ("whisper-medium", "train", (2, 3), {}, "ulysses_sp"),
    ("stablelm-3b", "train", (2, 2), {"tp_strategy": "heads_sp"},
     "heads_sp"),
    ("stablelm-3b", "train", (2, 2), {"tp_strategy": "ulysses"}, "ulysses"),
    ("stablelm-3b", "train", (2, 2), {"param_strategy": "zero2"}, "heads"),
    ("stablelm-3b", "train", (2, 2), {"param_strategy": "zero2_master"},
     "heads"),
    ("recurrentgemma-9b", "prefill", (2, 3), {}, "ulysses_sp"),
    ("recurrentgemma-9b", "decode", (2, 3), {}, "ulysses_sp"),
    ("whisper-medium", "prefill", (1, 2), {"tp_strategy": "ulysses_sp"},
     "ulysses_sp"),
    ("whisper-medium", "decode", (1, 2), {"tp_strategy": "ulysses_sp"},
     "ulysses_sp"),
    ("qwen3-14b", "decode", (2, 2), {"tp_strategy": "ulysses_sp"},
     "ulysses_sp"),
    ("stablelm-3b", "prefill", (2, 2), {"tp_strategy": "heads_sp"},
     "heads_sp"),
    ("olmoe-1b-7b", "decode", (1, 2), {"tp_strategy": "ulysses"},
     "ulysses"),
]


@pytest.mark.parametrize(
    "arch,kind,shape,replace,strategy", DRYRUN_CELLS,
    ids=[f"{a}-{k}-{'x'.join(map(str, s))}-{t}"
         + "".join(f"-{v}" for v in r.values() if v != t)
         for a, k, s, r, t in DRYRUN_CELLS])
def test_dryrun_cell_runs_every_coordinate(arch, kind, shape, replace,
                                           strategy):
    """The dry-run's cell on ``meta`` tensors runs every coordinate, its
    arguments at the bytes of the reference's specs, as
    ``test_torch_dryrun.py`` holds the default layouts."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun as D
    from test_torch_dryrun import _cfgs, _mesh as _meta_mesh
    from test_torch_dryrun import _reference_argument_bytes
    cfg, _ = _cfgs(arch, replace)
    mesh = _meta_mesh(shape)
    m = D.measure_cell(cfg, ShapeSpec("t", 64, 8, kind), mesh)
    coords = set(np.ndindex(mesh.devices.shape))
    assert m["ran"] == coords and set(m["flops"]) == coords
    assert all(f > 0 for f in m["flops"].values())
    want = _reference_argument_bytes(arch, kind, shape, replace)
    assert m["arguments"] == {c: want for c in coords}
    assert m["lowered"].rules.tp_strategy == strategy
