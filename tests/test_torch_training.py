"""The port's training against the JAX package's, on the CPU at reduced
configs: AdamW and the cosine schedule, the data stream, the train step
(with gradient accumulation and remat), checkpoints that each package
restores from the other, the crash-restart loop and the training CLI.

Tolerances: AdamW's parameters and moments rtol 1e-6, with an absolute
1e-6 of the leaf's largest entry (each op is the reference's; the two
libraries round ``pow`` and the norm's sum differently in the last bit,
which moves an entry near 0 by its leaf's rounding); train-step
parameters relative L2 1e-5 over the tree and 1e-4 per leaf (three steps
of float32 AdamW after gradients that agree to ~1e-6; see STEP_TOL);
remat and the restart loop bit-equal (the same ops recomputed on the
CPU); data and checkpoints bit-equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.launch import steps as steps_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro.training import checkpoint as ckpt_jax  # noqa: E402
from repro.training import data as data_jax  # noqa: E402
from repro.training import optimizer as opt_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import data, optimizer  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, train  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# parameters after AdamW steps, relative L2: the whole tree; and each
# leaf that does not start at 0, looser.  Adam's step is about lr·sign(g)
# for every entry, so an entry whose gradient is small carries its
# gradient's relative error in full, and a leaf that starts at 0 (norm
# scales, biases) is nothing but such steps: over 30 hash seeds of the
# reference's init, mamba2-2.7b's tree read at most 5.2e-6, its nonzero
# leaves 6e-6 and its zero-started ones up to 4e-3
STEP_TOL = 1e-5
LEAF_STEP_TOL = 1e-4


def assert_params_close(got, want, init):
    """``got`` against ``want`` (flat numpy trees) over the tree at
    STEP_TOL, and each leaf not 0 at ``init`` at LEAF_STEP_TOL."""
    assert rel_l2(np.concatenate([got[k].ravel() for k in want]),
                  np.concatenate([want[k].ravel() for k in want])) \
        <= STEP_TOL
    for k in want:
        if np.any(init[k]):
            assert rel_l2(got[k], want[k]) <= LEAF_STEP_TOL, k


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def to_np(tree):
    """Flat {key: float32/int numpy} of a JAX or a torch tree."""
    if isinstance(next(iter(flatten(tree).values())), torch.Tensor):
        return {k: (v.float() if v.dtype == torch.bfloat16 else v)
                .detach().numpy() for k, v in flatten(tree).items()}
    return {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                          else v) for k, v in flatten(
        jax.tree.map(lambda x: x, tree)).items()}


# ---------------------------------------------------------------------------
# AdamW and the schedule


def _tree(rng, scale=1.0):
    return {"w": rng.standard_normal((4, 8)) * scale,
            "layers": {"b0": {"scale": rng.standard_normal((3,)) * scale,
                              "mat": rng.standard_normal((2, 3, 5)) * scale}}}


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("clip", ["hit", "not_hit"])
@pytest.mark.parametrize("lr", ["constant", "cosine"])
def test_adamw_matches_reference(master, clip, lr):
    """Five updates on seeded numpy trees: the port's parameters,
    moments, master copy, count and grad norm against the reference's.
    Gradients of norm ~30 hit the clip at 1.0; of norm ~3e-3 do not."""
    rng = np.random.default_rng(0)
    params_np = jax.tree.map(lambda x: x.astype(np.float32), _tree(rng))
    kw = dict(weight_decay=0.1, clip_norm=1.0, master_weights=master)
    lr_j = 1e-2 if lr == "constant" else opt_jax.cosine_schedule(
        1e-2, warmup_steps=2, total_steps=5)
    lr_t = 1e-2 if lr == "constant" else optimizer.cosine_schedule(
        1e-2, warmup_steps=2, total_steps=5)
    oj, ot = opt_jax.AdamW(learning_rate=lr_j, **kw), \
        optimizer.AdamW(learning_rate=lr_t, **kw)
    pj = jax.tree.map(jnp.asarray, params_np)
    pt = jax.tree.map(torch.tensor, params_np)
    sj, st = oj.init(pj), ot.init(pt)
    if master:   # the working copy in bf16, as init_train_state makes it
        pj = jax.tree.map(lambda p: p.astype(jnp.bfloat16), pj)
        pt = jax.tree.map(lambda p: p.to(torch.bfloat16), pt)
    for _ in range(5):
        g = jax.tree.map(lambda x: x.astype(np.float32),
                         _tree(rng, 5.0 if clip == "hit" else 5e-4))
        pj, sj, mj = oj.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st, mt = ot.update(jax.tree.map(torch.tensor, g), st, pt)
        assert (float(mj["grad_norm"]) > 1.0) == (clip == "hit")
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
    for name, a, b in (("params", pt, pj), ("mu", st["mu"], sj["mu"]),
                       ("nu", st["nu"], sj["nu"])) + (
            (("master", st["master"], sj["master"]),) if master else ()):
        ta, tb = to_np(a), to_np(b)
        for k in tb:
            # rtol 1e-6, and as much absolute to the leaf's largest entry:
            # an entry near 0 keeps only its leaf's rounding
            np.testing.assert_allclose(ta[k], tb[k], rtol=1e-6,
                                       atol=1e-6 * np.abs(tb[k]).max(),
                                       err_msg=f"{name}/{k}")
    assert int(st["count"]) == int(sj["count"]) == 5
    assert all(p.dtype == (torch.bfloat16 if master else torch.float32)
               for p in flatten(pt).values())


def test_cosine_schedule_matches_reference():
    lj = opt_jax.cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    lt = optimizer.cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 5, 10, 55, 100, 130):
        assert float(lt(s)) == float(lj(s)), s
    assert float(lt(0)) == 0.0 and abs(float(lt(10)) - 1e-3) < 1e-9


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_dataset_bit_equal_to_reference(seed):
    for num_hosts in (1, 2):
        for host in range(num_hosts):
            kw = dict(vocab_size=512, batch_size=8, seq_len=16, seed=seed,
                      host_id=host, num_hosts=num_hosts)
            dj, dt = data_jax.LMDataset(**kw), data.LMDataset(**kw)
            for step in range(4):
                bj, bt = dj.batch(step), dt.batch(step)
                assert bj.keys() == bt.keys()
                for k in bj:
                    assert bt[k].dtype == bj[k].dtype == np.int32
                    np.testing.assert_array_equal(bt[k], bj[k])


# ---------------------------------------------------------------------------
# the train step


def _pair(name, **replace):
    """The reduced config in both packages, the same parameters (the
    reference's init, converted)."""
    cj = get_config_jax(name).reduced().replace(**replace)
    ct = get_config(name).reduced().replace(**replace)
    mj, mt = build_jax(cj), build_model(ct)
    pj = mj.init(jax.random.PRNGKey(0))
    pt = from_jax(ct, jax.tree.map(np.asarray, pj), device="cpu")
    return mj, pj, mt, pt


def _batches(vocab, n, B=4, S=16, seed=1):
    ds = data.LMDataset(vocab_size=vocab, batch_size=B, seq_len=S,
                        seed=seed)
    return [ds.batch(i) for i in range(n)]


@pytest.mark.parametrize("name", ["stablelm-3b", "mamba2-2.7b"])
def test_train_step_matches_reference(name):
    """Three steps of the port's train step against the reference's jitted
    one: loss each step, parameters and moments after."""
    mj, pj, mt, pt = _pair(name)
    init = to_np(pt)
    oj, ot = opt_jax.AdamW(learning_rate=1e-3), \
        optimizer.AdamW(learning_rate=1e-3)
    sj = {"params": pj, "opt": oj.init(pj), "step": jnp.zeros((), jnp.int32)}
    st = {"params": pt, "opt": ot.init(pt),
          "step": torch.zeros((), dtype=torch.int32)}
    fj = jax.jit(steps_jax.make_train_step(mj, oj))
    ft = steps.make_train_step(mt, ot)
    for b in _batches(mt.cfg.vocab_size, 3):
        sj, mj_ = fj(sj, {k: jnp.asarray(v) for k, v in b.items()})
        st, mt_ = ft(st, steps.device_batch(b, "cpu"))
        np.testing.assert_allclose(float(mt_["loss"]), float(mj_["loss"]),
                                   rtol=1e-5)
        assert set(mt_) == set(mj_)
    assert int(st["step"]) == int(sj["step"]) == 3
    assert_params_close(to_np(st["params"]), to_np(sj["params"]), init)
    a, b = to_np(st["opt"]["mu"]), to_np(sj["opt"]["mu"])
    assert rel_l2(np.concatenate([a[k].ravel() for k in b]),
                  np.concatenate([b[k].ravel() for k in b])) <= 1e-4


def test_microbatches_match_one_batch():
    """microbatches=2 on a batch: the mean of the two halves' gradients is
    the whole batch's, so one step lands where microbatches=1 does (and
    where the reference's two-microbatch scan does)."""
    mj, pj, mt1, pt = _pair("stablelm-3b", microbatches=2)
    init = to_np(pt)
    mt2 = build_model(mt1.cfg)
    mt1 = build_model(mt1.cfg.replace(microbatches=1))
    b = _batches(mt1.cfg.vocab_size, 1)[0]
    out = {}
    for label, model in (("m1", mt1), ("m2", mt2)):
        ot = optimizer.AdamW(learning_rate=1e-3)
        p = jax.tree.map(torch.clone, pt)
        st = {"params": p, "opt": ot.init(p),
              "step": torch.zeros((), dtype=torch.int32)}
        st, m = steps.make_train_step(model, ot)(st, steps.device_batch(
            b, "cpu"))
        out[label] = (to_np(st["params"]), float(m["loss"]))
    oj = opt_jax.AdamW(learning_rate=1e-3)
    sj, m = jax.jit(steps_jax.make_train_step(mj, oj))(
        {"params": pj, "opt": oj.init(pj), "step": jnp.zeros((), jnp.int32)},
        {k: jnp.asarray(v) for k, v in b.items()})
    ref = to_np(sj["params"])
    np.testing.assert_allclose(out["m2"][1], out["m1"][1], rtol=1e-5)
    np.testing.assert_allclose(out["m2"][1], float(m["loss"]), rtol=1e-5)
    assert_params_close(out["m2"][0], out["m1"][0], init)
    assert_params_close(out["m2"][0], ref, init)


def _loss_grads(model, params, batch):
    flat = {k: v.detach().requires_grad_() for k, v in
            flatten(params).items()}
    from repro_torch.training.tree import unflatten
    loss, _ = model.loss_fn(unflatten(params, flat), batch)
    return loss, dict(zip(flat, torch.autograd.grad(loss, list(
        flat.values()))))


REMAT_FAMILIES = ["stablelm-3b", "recurrentgemma-9b", "mamba2-2.7b",
                  "whisper-medium"]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", REMAT_FAMILIES)
def test_remat_gradients_equal_none(name, remat):
    """Recomputing the layer groups in the backward gives the gradients of
    keeping every activation, bit for bit on the CPU."""
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = steps.device_batch(_batches(cfg.vocab_size, 1, B=2)[0], "cpu")
    if cfg.family == "enc_dec":
        batch["encoder_frames"] = torch.randn(
            2, cfg.enc_seq, cfg.d_model, generator=torch.Generator()
            .manual_seed(0))
    l0, g0 = _loss_grads(model, params, batch)
    l1, g1 = _loss_grads(build_model(cfg.replace(remat=remat)), params,
                         batch)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_remat_full_launch_pattern(monkeypatch):
    """With remat="full" a train step runs each kernel's forward once and
    once more in the recompute, and the RG-LRU scan a third time in its
    backward: the counts the chip phases hold (flash 2 per attention
    layer, RG-LRU 3 per recurrent block, SSD 2 per block)."""
    calls = {}

    def counting(name, mod):
        real = mod._forward
        monkeypatch.setattr(mod, "_forward", lambda *a, **k: calls.update(
            {name: calls.get(name, 0) + 1}) or real(*a, **k))

    for name, mod in (("flash", fa_ops), ("rglru", lru_ops),
                      ("ssd", ssd_ops)):
        counting(name, mod)
    for name, want in (("recurrentgemma-9b", {"flash": 2, "rglru": 6}),
                       ("mamba2-2.7b", {"ssd": 4}),
                       ("stablelm-3b", {"flash": 4})):
        cfg = get_config(name).reduced().replace(remat="full")
        model = build_model(cfg)
        ot = optimizer.AdamW(learning_rate=1e-4)
        st = steps.init_train_state(model, ot, 0, device="cpu")
        b = steps.device_batch(_batches(cfg.vocab_size, 1, B=2)[0], "cpu")
        calls.clear()
        steps.make_train_step(model, ot)(st, b)
        assert calls == want, name
        kinds = lm.block_kinds(cfg)
        assert 2 * sum(k.startswith("attn") for k in kinds) \
            == want.get("flash", 0)


# ---------------------------------------------------------------------------
# checkpoints


def _state_pair():
    """The same train state in both packages (reduced stablelm-3b after
    one step, so the moments are not zero)."""
    mj, pj, mt, pt = _pair("stablelm-3b")
    ot = optimizer.AdamW(learning_rate=1e-3)
    st = {"params": pt, "opt": ot.init(pt),
          "step": torch.zeros((), dtype=torch.int32)}
    st, _ = steps.make_train_step(mt, ot)(
        st, steps.device_batch(_batches(mt.cfg.vocab_size, 1)[0], "cpu"))
    sj = jax.tree.map(jnp.asarray, jax.tree.map(
        lambda t: t.numpy(), st, is_leaf=lambda x: isinstance(
            x, torch.Tensor)))
    return st, sj


def _bit_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x = fa[k].numpy() if isinstance(fa[k], torch.Tensor) \
            else np.asarray(fa[k])
        y = fb[k].numpy() if isinstance(fb[k], torch.Tensor) \
            else np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_checkpoint_reference_to_port_and_back(tmp_path):
    """A train state saved by the reference restores bit-equal in the
    port, and the port's save restores bit-equal in the reference; the
    two directories hold the same files, byte for byte."""
    st, sj = _state_pair()
    ckpt_jax.save(tmp_path / "jax", 7, sj)
    got, step = ckpt.restore(tmp_path / "jax", st, device="cpu")
    assert step == 7
    _bit_equal(got, st)
    ckpt.save(tmp_path / "pt", 7, st)
    back, step = ckpt_jax.restore(tmp_path / "pt", sj)
    assert step == 7
    _bit_equal(back, sj)
    a, b = tmp_path / "jax" / "step_00000007", tmp_path / "pt" / \
        "step_00000007"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_checkpoint_bf16_leaves_match_the_reference(tmp_path):
    """A bfloat16 leaf: the port writes the reference's header ('<V2')
    and bytes, names it "bfloat16" in the manifest, and reads the
    reference's file back as bfloat16."""
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    tree_j = {"w": jnp.asarray(x, jnp.bfloat16),
              "s": jnp.asarray(x[0], jnp.float32)}
    tree_t = {"w": torch.tensor(x).to(torch.bfloat16),
              "s": torch.tensor(x[0])}
    dj = ckpt_jax.save(tmp_path / "jax", 1, tree_j)
    dt = ckpt.save(tmp_path / "pt", 1, tree_t)
    for f in ("w.npy", "s.npy", "manifest.json"):
        assert (dj / f).read_bytes() == (dt / f).read_bytes(), f
    got, _ = ckpt.restore(tmp_path / "jax", tree_t, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tree_t["w"])
    assert torch.equal(got["s"], tree_t["s"])


def test_failed_save_leaves_no_step_directory(tmp_path, monkeypatch):
    tree = {"a": torch.zeros(3), "b": torch.ones(2)}
    real = ckpt._write_leaf

    def fail_second(path, arr, dtype):
        if path.name == "b.npy":
            raise OSError("disk full")
        real(path, arr, dtype)

    monkeypatch.setattr(ckpt, "_write_leaf", fail_second)
    with pytest.raises(OSError):
        ckpt.save(tmp_path, 3, tree)
    assert not list(tmp_path.glob("step_*"))
    assert ckpt.latest_step(tmp_path) is None
    monkeypatch.setattr(ckpt, "_write_leaf", real)
    ckpt.save(tmp_path, 3, tree)
    assert ckpt.latest_step(tmp_path) == 3


def test_restore_refuses_shardings(tmp_path):
    """A sharding that does not split its leaf evenly is refused; one
    that does restores the leaf onto the mesh."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.sharding.placement import NamedSharding
    ckpt.save(tmp_path, 1, {"a": torch.arange(3.0)})
    mesh = make_serving_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="split"):
        ckpt.restore(tmp_path, {"a": torch.zeros(3)},
                     shardings={"a": NamedSharding(mesh, ("model",))})
    got, _ = ckpt.restore(tmp_path, {"a": torch.zeros(3)},
                          shardings={"a": NamedSharding(mesh, (None,))})
    assert torch.equal(got["a"].full(), torch.arange(3.0))


# ---------------------------------------------------------------------------
# the restart loop and the CLI


@pytest.fixture(scope="module")
def tiny():
    return build_model(get_config("stablelm-3b").reduced())


def test_loss_decreases(tiny, tmp_path):
    tcfg = TrainConfig(steps=30, ckpt_every=30, log_every=1,
                       ckpt_dir=str(tmp_path / "ck"), async_ckpt=False)
    _, history = train(tiny, tcfg, log=lambda *_: None, device="cpu")
    assert history[-1][1] < 0.9 * history[0][1], history


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_failure_injection_resumes_identically(tiny, tmp_path, async_ckpt):
    """A crash at step 25 resumes from step 20 and reaches the final state
    of an uninterrupted run, bit for bit (the reference's test)."""
    common = dict(steps=40, ckpt_every=10, log_every=40,
                  async_ckpt=async_ckpt)
    logs = []
    s_clean, _ = train(tiny, TrainConfig(
        ckpt_dir=str(tmp_path / "clean"), **common), log=lambda *_: None,
        device="cpu")
    s_faulty, _ = train(tiny, TrainConfig(
        ckpt_dir=str(tmp_path / "faulty"), fail_at_step=25, **common),
        log=logs.append, device="cpu")
    assert any("injected fault at step 25" in m for m in logs)
    assert any("resumed from step 20" in m for m in logs)
    _bit_equal(s_clean, s_faulty)


def test_max_restarts_bounds_the_loop(tiny, tmp_path):
    from repro_torch.training.train_loop import InjectedFailure
    with pytest.raises(InjectedFailure):
        train(tiny, TrainConfig(steps=4, ckpt_every=2, fail_at_step=1,
                                max_restarts=0, async_ckpt=False,
                                ckpt_dir=str(tmp_path)),
              log=lambda *_: None, device="cpu")


def test_entry_points_default_to_cuda(tiny, tmp_path):
    """Every training entry point asks for the card by default and raises
    without one; nothing quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    ot = optimizer.AdamW()
    with pytest.raises(RuntimeError, match="cuda"):
        steps.init_train_state(tiny, ot)
    with pytest.raises(RuntimeError, match="cuda"):
        train(tiny, TrainConfig(steps=1, ckpt_dir=str(tmp_path)),
              log=lambda *_: None)
    ckpt.save(tmp_path, 1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.restore(tmp_path, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="cuda"):
        steps.device_batch({"tokens": np.zeros((1, 2), np.int32)}, "cuda")


def _cli(tmp_path, *args):
    # one intra-op thread: the test runs beside other test workers
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "stablelm-3b", "--smoke", "--ckpt-dir", str(tmp_path / "ck"),
         *args], capture_output=True, text=True, env=env, timeout=240)


def test_train_cli_smoke_on_cpu(tmp_path):
    r = _cli(tmp_path, "--device", "cpu", "--steps", "10")
    assert r.returncode == 0, r.stderr
    assert "done: final loss" in r.stdout and "device=cpu" in r.stdout
    assert ckpt.latest_step(tmp_path / "ck") == 10


def test_train_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    r = _cli(tmp_path, "--steps", "1")
    assert r.returncode != 0 and "torch.cuda.is_available() is False" \
        in r.stderr
