"""The port's dense and MoE LMs against the JAX package, on the same
parameters.

JAX initializes (its init seeds from ``hash(path)``, which changes per
process), the tree goes to the port through ``convert.from_jax``, and the
same numpy inputs run through both.  Reduced configs are float32.
Logits agree to rtol = atol = 1e-4, not bit for bit: XLA and PyTorch sum
the matmuls and softmax reductions in different orders, which moves the
last few float32 bits through every layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro.models import common as common_jax  # noqa: E402
from repro.models import mlp as mlp_jax  # noqa: E402
from repro.models import moe as moe_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common, mlp, moe  # noqa: E402
from repro_torch.models.convert import from_jax, to_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["stablelm-3b", "qwen3-14b", "qwen2.5-32b", "yi-34b",
         "olmoe-1b-7b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg_j = get_config_jax(request.param).reduced()
    cfg_t = get_config(request.param).reduced()
    mj = build_jax(cfg_j)
    params_j = mj.init(jax.random.PRNGKey(7))
    params_np = jax.tree.map(np.asarray, params_j)
    mt = build_model(cfg_t)
    params_t = from_jax(cfg_t, params_np, device="cpu")
    return cfg_t, mj, params_j, params_np, mt, params_t


def t(x):
    return torch.tensor(np.asarray(x))


def test_configs_match_reference():
    for name in ARCHS + ["recurrentgemma-9b", "mamba2-2.7b"]:
        for reduce in (False, True):
            a = get_config(name)
            b = get_config_jax(name)
            if reduce:
                a, b = a.reduced(), b.reduced()
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.vocab_padded == b.vocab_padded
            assert (a.d_inner, a.ssm_heads) == (b.d_inner, b.ssm_heads)
            assert str(a.activation_dtype).split(".")[-1] == \
                str(b.activation_dtype)


def test_round_trip_bit_for_bit(pair):
    _, _, _, params_np, mt, params_t = pair
    back = to_numpy(params_t)
    flat_a = jax.tree_util.tree_leaves_with_path(params_np)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        other = flat_b[path]
        assert other.dtype == leaf.dtype and other.shape == leaf.shape
        assert np.array_equal(other, leaf), path
    # the port's own schema has the reference's shapes
    shapes = jax.tree.map(lambda s: tuple(s.shape), params_np)

    def spec_shapes(tree):
        return {k: spec_shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert spec_shapes(mt.schema()) == shapes
    init = mt.init(3, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), to_numpy(init)) == shapes


def test_hybrid_round_trip_bit_for_bit():
    """``from_jax`` → ``to_numpy`` on the hybrid tree: stacked
    ``layers/b0..b2`` super-blocks plus the unrolled ``tail0``/``tail1``,
    leaf for leaf and bit for bit, in float32 and bfloat16."""
    cfg = get_config("recurrentgemma-9b").reduced().replace(num_layers=5)
    mj = build_jax(get_config_jax("recurrentgemma-9b").reduced()
                   .replace(num_layers=5))
    params_np = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(5)))
    assert set(params_np["layers"]) == {"b0", "b1", "b2"}
    assert {"tail0", "tail1"} <= set(params_np)
    assert "rglru" in params_np["tail1"]
    shapes = jax.tree.map(lambda a: a.shape, params_np)

    def spec_shapes(tree):
        return {k: spec_shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert spec_shapes(build_model(cfg).schema()) == shapes
    for dtype in (np.float32, jnp.bfloat16):
        tree = jax.tree.map(lambda a: np.asarray(a, dtype), params_np)
        back = to_numpy(from_jax(cfg, tree, device="cpu"))
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            assert np.array_equal(flat_b[path],
                                  np.asarray(leaf, np.float32)), path


def test_norms_rope_mlp_match_reference(pair):
    cfg, _, _, params_np, _, params_t = pair
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    scale = rng.randn(cfg.d_model).astype(np.float32) * 0.1
    bias = rng.randn(cfg.d_model).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        common.rmsnorm(t(x), t(scale), 1e-6).numpy(),
        np.asarray(common_jax.rmsnorm(jnp.asarray(x), jnp.asarray(scale),
                                      1e-6)), **TOL)
    np.testing.assert_allclose(
        common.layernorm(t(x), t(scale), t(bias), 1e-5).numpy(),
        np.asarray(common_jax.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(bias), 1e-5)), **TOL)
    pos = np.asarray([[0, 3, 17, 100, 999]] * 2, np.int32)
    hd = cfg.head_dim
    cj, sj = common_jax.rope_cos_sin(jnp.asarray(pos), hd, cfg.rope_theta,
                                     jnp.float32)
    ct, st = common.rope_cos_sin(t(pos), hd, cfg.rope_theta, torch.float32)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    xh = rng.randn(2, 5, 3, hd).astype(np.float32)
    np.testing.assert_allclose(
        common.apply_rope(t(xh), ct, st).numpy(),
        np.asarray(common_jax.apply_rope(jnp.asarray(xh), cj, sj)), **TOL)
    # the feed-forward: an MLP, or an MoE layer with its aux loss
    ffn = "moe" if cfg.family == "moe" else "mlp"
    p_np = jax.tree.map(lambda a: a[0], params_np["layers"]["b0"][ffn])
    p_t = {k: v[0] for k, v in params_t["layers"]["b0"][ffn].items()}
    p_j = jax.tree.map(jnp.asarray, p_np)
    if ffn == "mlp":
        np.testing.assert_allclose(
            mlp.apply_mlp(cfg, p_t, t(x)).numpy(),
            np.asarray(mlp_jax.apply_mlp(cfg, p_j, jnp.asarray(x))), **TOL)
        return
    cfg_j = get_config_jax(cfg.name).reduced()
    yj, auxj = moe_jax.apply_moe(cfg_j, p_j, jnp.asarray(x))
    yt, auxt = moe.apply_moe(cfg, p_t, t(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)


def test_forward_logits_match(pair):
    cfg, mj, params_j, _, mt, params_t = pair
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 12))
    lj, auxj = mj.forward(params_j,
                          {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        lt, auxt = mt.forward(params_t, {"tokens": t(toks.astype(np.int32))})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # the sum of the MoE layers' Switch losses (0 for a dense model)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    assert (float(auxt) > 0) == (cfg.family == "moe")


def _jax_kv(cache):
    return {n: np.asarray(cache["layers"]["b0"][n]) for n in ("k", "v")}


def test_prefill_with_prefix_matches(pair):
    """Suffix prefill over a padded prefix whose valid length is below the
    padded length, reading the logits at ``last_index`` (a padded suffix,
    as the engine's buckets make)."""
    cfg, mj, params_j, _, mt, params_t = pair
    rng = np.random.RandomState(3)
    plen, Tpad, L, Sb = 5, 8, 6, 8
    prompt = rng.randint(0, cfg.vocab_size, (1, plen + L)).astype(np.int32)
    _, pcache = mj.prefill(params_j, {"tokens": jnp.asarray(prompt[:, :plen])},
                           capacity=Tpad)
    sfx = np.zeros((1, Sb), np.int32)
    sfx[0, :L] = prompt[0, plen:]
    lj, cj = mj.prefill(params_j, {"tokens": jnp.asarray(sfx)}, capacity=Sb,
                        prefix=pcache, prefix_len=jnp.asarray(plen),
                        last_index=jnp.asarray(L - 1))
    prefix_t = {n: t(a) for n, a in _jax_kv(pcache).items()}
    with torch.no_grad():
        lt, ct = mt.prefill(params_t, {"tokens": t(sfx)}, capacity=Sb,
                            prefix=prefix_t, prefix_len=plen,
                            last_index=L - 1)
        # the port's own prefix prefill agrees with the JAX one
        _, pt_cache = mt.prefill(params_t, {"tokens": t(prompt[:, :plen])},
                                 capacity=Tpad)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for n, a in _jax_kv(cj).items():
        np.testing.assert_allclose(ct[n].numpy(), a, **TOL)
    for n, a in _jax_kv(pcache).items():
        np.testing.assert_allclose(pt_cache[n].numpy(), a, **TOL)
    # and it equals the full-prompt logits at that position
    full, _ = mj.forward(params_j, {"tokens": jnp.asarray(prompt)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(full[:, -1]), **TOL)


def test_decode_steps_through_shuffled_page_table(pair):
    """Three chained paged decode steps, with the pool's pages shuffled
    between two sequences and the current token's K/V written in place."""
    cfg, mj, params_j, _, mt, params_t = pair
    rng = np.random.RandomState(4)
    B, ps, N = 2, 4, 4
    P = B * N + 2
    pools_j = mj.init_paged_cache(P, ps)
    shape = pools_j["layers"]["b0"]["k"].shape
    kv = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    pools_j = {"layers": {"b0": {n: jnp.asarray(a) for n, a in kv.items()}}}
    pools_t = {n: t(a.copy()) for n, a in kv.items()}
    table = (rng.permutation(P - 1)[: B * N] + 1).reshape(B, N)
    table = table.astype(np.int32)
    positions = np.asarray([6, 11], np.int32)
    toks = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    for _ in range(3):
        lj, pools_j = mj.decode_step_paged(
            params_j, pools_j, jnp.asarray(toks), jnp.asarray(positions),
            jnp.asarray(table))
        with torch.no_grad():
            lt, pools_t = mt.decode_step_paged(
                params_t, pools_t, t(toks), t(positions), t(table))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        assert np.array_equal(lt.numpy().argmax(-1),
                              np.asarray(lj).argmax(-1))
        toks = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
        positions = positions + 1
    for n, a in _jax_kv(pools_j).items():
        np.testing.assert_allclose(pools_t[n].numpy(), a, **TOL)


def test_unported_families_raise():
    """Every family of the reference now runs: a family the reference
    does not have raises, the decoder-only LM refuses the
    encoder-decoder (which runs in ``models.encdec``), and the VLM takes
    the paged layout like the dense family; so do MoE models."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import lm
    base = ModelConfig(name="m", family="enc_dec", num_layers=1, d_model=8,
                       num_heads=2, num_kv_heads=2, head_dim=4, d_ff=8,
                       vocab_size=300)
    other = base.replace(family="rnn")
    with pytest.raises(ValueError, match="no decoder-only LM"):
        lm.lm_schema(other)
    with pytest.raises(ValueError, match="no decoder-only LM"):
        build_model(other).prefix_seq_axes()
    with pytest.raises(ValueError, match="models.encdec"):
        lm.lm_schema(base)
    assert build_model(base).prefix_seq_axes() is None
    assert build_model(base).schema().keys() == {
        "embed", "enc_final_norm", "dec_final_norm", "enc_layers",
        "dec_layers"}
    vlm = get_config("pixtral-12b").reduced()
    assert build_model(vlm).prefix_seq_axes() == {"k": 2, "v": 2}
    assert not lm.is_contiguous(vlm)
    assert lm.block_kinds(vlm) == ["attn_mlp"] * vlm.num_layers
    for name in ("olmoe-1b-7b", "qwen3-moe-30b-a3b"):
        red = get_config(name).reduced()
        assert (red.num_experts, red.moe_capacity_factor) == (8, 8.0)
        assert build_model(red).prefix_seq_axes() == {"k": 2, "v": 2}
        assert not lm.is_contiguous(red)
        assert lm.block_kinds(red) == ["attn_moe"] * red.num_layers
        assert lm.lm_schema(red)["layers"]["b0"].keys() \
            == {"ln1", "attn", "ln2", "moe"}
    hybrid = get_config("recurrentgemma-9b").reduced()
    assert build_model(hybrid).prefix_seq_axes() is None
    assert lm.lm_schema(hybrid)["layers"].keys() == {"b0", "b1", "b2"}
    ssm = get_config("mamba2-2.7b").reduced()
    assert build_model(ssm).prefix_seq_axes() is None
    assert lm.lm_schema(ssm)["layers"]["b0"].keys() == {"ln1", "ssd"}


def test_arch_ids_match_reference():
    """The port lists the reference's architectures in the reference's
    order, element for element."""
    from repro.configs import ARCH_IDS as ref_ids
    from repro_torch.configs import ARCH_IDS
    assert ARCH_IDS == ref_ids
