"""The port's dry-run (``repro_torch.launch.dryrun``): cells run on
``meta`` tensors for every coordinate of a small mesh, with reduced
configs at ``vocab_size=512`` (the cells of ``test_dryrun_small``, a
``ulysses_sp`` cell of each kind and a (2, 2, 2) cell).

Each coordinate's argument bytes are held to the sum of its local
shapes under the reference's specs (``repro.sharding.rules`` on a fake
mesh of the same shape), a decode cell's ``serving_kv`` to the
reference's cache bytes, the FLOPs of a (1, 1) mesh to
``FlopCounterMode`` of the single-device step on ``meta`` tensors plus
the kernels' own counts, and the collectives to closed forms."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.configs import input_specs as input_specs_jax  # noqa: E402
from repro.launch import steps as steps_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro.sharding import rules as rules_jax  # noqa: E402
from repro.training.optimizer import AdamW as AdamWJax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

CELLS = [
    ("qwen3-14b", "train", (4, 2), {}),
    ("olmoe-1b-7b", "train", (4, 2), {}),
    ("mamba2-2.7b", "train", (4, 2), {}),
    ("whisper-medium", "train", (4, 2), {}),
    ("recurrentgemma-9b", "decode", (4, 2), {}),
    ("stablelm-3b", "decode", (4, 2), {}),
    ("qwen3-14b", "prefill", (4, 2), {}),
    ("qwen3-14b", "train", (4, 2), {"tp_strategy": "ulysses_sp"}),
    # 4 KV heads on 8 shards: the cache splits by sequence, as qwen3-14b's
    # 8 do on 16
    ("qwen3-14b", "prefill", (2, 8), {"tp_strategy": "ulysses_sp"}),
    ("qwen3-14b", "decode", (2, 8), {"tp_strategy": "ulysses_sp"}),
    ("stablelm-3b", "train", (2, 2, 2), {}),
]


def _mesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                             "model")
    n = int(np.prod(shape))
    return Mesh(np.array(["meta"] * n, dtype=object).reshape(shape), axes)


class _FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _cfgs(arch, replace):
    return (get_config(arch).reduced().replace(vocab_size=512, **replace),
            get_config_jax(arch).reduced().replace(vocab_size=512,
                                                   **replace))


def _local_bytes(shape, dtype, spec, sizes):
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        k = 1
        for a in (() if entry is None else (entry,) if isinstance(
                entry, str) else entry):
            k *= sizes[a]
        n *= d // k
    return n * np.dtype(dtype).itemsize


def _tree_local_bytes(tree, specs, sizes):
    if isinstance(tree, dict):
        return sum(_tree_local_bytes(v, specs[k], sizes)
                   for k, v in tree.items())
    return _local_bytes(tree.shape, tree.dtype, tuple(specs), sizes)


def _reference_argument_bytes(arch, kind, shape, replace, seq=64, batch=8):
    """Every coordinate's argument bytes under the reference's specs (its
    ``lower_cell``'s in_shardings)."""
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                             "model")
    mesh = _FakeMesh(shape, axes)
    sizes = dict(zip(axes, shape))
    _, cfg = _cfgs(arch, replace)
    sh = ShapeSpec("t", seq, batch, kind)
    if kind == "train":
        m = steps_jax.pick_microbatches(cfg, sh, mesh)
        if m > 1:
            cfg = cfg.replace(microbatches=m)
    model = build_jax(cfg)
    rls = rules_jax.make_rules(mesh, cfg)
    specs = input_specs_jax(cfg, sh)
    total = _tree_local_bytes(specs, rules_jax.batch_pspecs(rls, specs),
                              sizes)
    if kind == "train":
        opt = AdamWJax(master_weights=cfg.param_strategy == "zero2_master")
        state = steps_jax.abstract_train_state(model, opt)
        return total + _tree_local_bytes(
            state, steps_jax.train_state_pspecs(rls, model, opt), sizes)
    params = model.abstract_params(dtype=cfg.serve_param_dtype)
    total += _tree_local_bytes(params, rules_jax.params_pspecs(rls, model),
                               sizes)
    if kind == "decode":
        cache = model.init_cache(batch, seq, abstract=True)
        total += _tree_local_bytes(cache, rules_jax.cache_pspecs(rls, cache),
                                   sizes)
    return total


@pytest.mark.parametrize(
    "arch,kind,shape,replace", CELLS,
    ids=[f"{a}-{k}-{'x'.join(map(str, s))}{'-ulysses' if r else ''}"
         for a, k, s, r in CELLS])
def test_cell_runs_every_coordinate(arch, kind, shape, replace):
    cfg, _ = _cfgs(arch, replace)
    mesh = _mesh(shape)
    m = D.measure_cell(cfg, ShapeSpec("t", 64, 8, kind), mesh)
    assert m["ran"] == set(np.ndindex(mesh.devices.shape))
    assert set(m["flops"]) == set(np.ndindex(mesh.devices.shape))
    assert all(f > 0 for f in m["flops"].values())
    want = _reference_argument_bytes(arch, kind, shape, replace)
    assert m["arguments"] == {c: want
                              for c in np.ndindex(mesh.devices.shape)}
    assert all(m["peak"][c] >= want for c in m["peak"])
    if replace:
        assert m["lowered"].rules.tp_strategy == "ulysses_sp"


def test_train_peak_holds_the_microbatch_accumulator():
    """A train cell of two microbatches runs its first one with the
    float32 accumulator that every later one keeps alive: its peak is
    that of one microbatch of the same size alone plus, on each
    coordinate, the accumulator (its float32 parameter slices) and the
    batch's other half."""
    from repro_torch.training.tree import flatten
    mesh = _mesh((4, 2))
    got = {}
    for M, B in ((1, 8), (2, 16)):
        cfg, _ = _cfgs("stablelm-3b", {})
        got[M] = D.measure_cell(cfg.replace(microbatches=M),
                                ShapeSpec("t", 64, B, "train"), mesh)
    state, _ = got[2]["lowered"].place()
    for c in np.ndindex(mesh.devices.shape):
        acc = sum(t.local(c).numel() * 4
                  for t in flatten(state["params"]).values())
        extra = got[2]["arguments"][c] - got[1]["arguments"][c]
        assert got[2]["peak"][c] - got[1]["peak"][c] == acc + extra


def test_serving_kv_and_record(tmp_path, monkeypatch):
    """A decode record carries the serving KV estimate, equal to the
    reference's cache bytes; the record's fields are the reference's."""
    cfg, cfg_j = _cfgs("stablelm-3b", {})
    mesh = _mesh((4, 2))
    monkeypatch.setattr(D, "get_config", lambda name: cfg)
    monkeypatch.setattr(D, "SHAPES", {"t": ShapeSpec("t", 64, 8, "decode")})
    rec = D.run_cell("stablelm-3b", "t", mesh, "small", tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 8 and rec["tp_strategy"] == "heads"
    kv = rec["serving_kv"]
    assert kv == D.serving_kv_estimate(cfg, max_slots=8, max_len=64)
    ref = build_jax(cfg_j).init_cache(8, 64, abstract=True)
    import jax
    ref_bytes = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                    for x in jax.tree.leaves(ref))
    assert kv["contiguous_bytes"] == ref_bytes
    for k in ("flops_per_device", "memory", "collectives", "num_params"):
        assert k in rec
    assert json.loads((tmp_path / "stablelm-3b__t__small.json")
                      .read_text())["status"] == "ok"


@pytest.mark.parametrize("arch", ["stablelm-3b", "olmoe-1b-7b"])
def test_flops_on_one_device_equal_the_flop_counter(arch):
    """On a (1, 1) mesh the step's FLOPs equal ``FlopCounterMode`` of the
    single-device train step on ``meta`` tensors plus the kernels' own
    counts (the flash forward's, metered on ``meta``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training.optimizer import AdamW
    cfg, _ = _cfgs(arch, {})
    sh = ShapeSpec("t", 64, 8, "train")
    m = D.measure_cell(cfg, sh, _mesh((1, 1)))
    model = build_model(cfg)
    opt = AdamW()
    state = ST.abstract_train_state(model, opt)
    from repro_torch.configs.shapes import input_specs
    batch = input_specs(cfg, sh)
    kernel = []
    prev = _build.METER
    _build.METER = lambda name, flops, nbytes, like: kernel.append(flops)
    try:
        with FlopCounterMode(display=False) as fc:
            ST.make_train_step(model, opt)(state, batch)
    finally:
        _build.METER = prev
    assert m["flops"][(0, 0)] == fc.get_total_flops() + sum(kernel)
    assert m["kernel_flops"][(0, 0)] == sum(kernel) > 0


def test_collectives_closed_form():
    """A (4, 2) train cell of the reduced dense model, no remat, one
    microbatch: each coordinate receives one all-gather a use of a leaf
    (every leaf of stablelm has a dim over ``data``: the top leaves once,
    each layer's leaves once a layer) and one reduce-scatter a leaf
    gradient; the data rows' loss mean is one all-reduce more than the
    per-layer sums."""
    cfg, _ = _cfgs("stablelm-3b", {})
    assert cfg.remat == "none"
    mesh = _mesh((4, 2))
    m = D.measure_cell(cfg, ShapeSpec("t", 64, 8, "train"), mesh)
    model = build_model(cfg)
    n_uses = sum(cfg.num_layers if p.startswith("layers/") else 1
                 for p, _ in D.placement.leaf_paths(model.schema()))
    for c in np.ndindex(mesh.devices.shape):
        got = m["collectives"][c]
        assert got["all-gather"]["count"] == n_uses, c
        assert got["reduce-scatter"]["count"] == n_uses, c
        assert "all-to-all" not in got


def test_main_writes_its_json(tmp_path, monkeypatch):
    """``main`` over one small cell: the JSON lands in ``--out`` and the
    exit code is 0 (the production meshes are swapped for a (2, 2) one
    and the config for its reduced form to keep the test small)."""
    from repro_torch.launch import mesh as M
    cfg, _ = _cfgs("mamba2-2.7b", {})
    monkeypatch.setattr(D, "get_config", lambda name: cfg)
    monkeypatch.setattr(M, "make_production_mesh",
                        lambda multi_pod=False, devices=None: _mesh(
                            (1, 2, 2) if multi_pod else (2, 2)))
    monkeypatch.setattr(D, "SHAPES", {"t": ShapeSpec("t", 64, 8, "decode")})
    rc = D.main(["--arch", "mamba2-2.7b", "--shape", "t", "--mesh", "both",
                 "--out", str(tmp_path)])
    assert rc == 0
    for name in ("pod16x16", "multipod2x16x16"):
        rec = json.loads((tmp_path / f"mamba2-2.7b__t__{name}.json")
                         .read_text())
        assert rec["status"] == "ok"


def test_main_skips_long_context_for_attention_archs(tmp_path, monkeypatch):
    from repro_torch.launch import mesh as M
    monkeypatch.setattr(M, "make_production_mesh",
                        lambda multi_pod=False, devices=None: _mesh((1, 1)))
    rc = D.main(["--arch", "stablelm-3b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(tmp_path)])
    assert rc == 0
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# each kernel's reckoning of its work (``*_work`` beside its wrapper), the
# one the kernels phase's bounds and the meta branches both use

HBM, PEAK = 3.35e12, {"bfloat16": 989e12, "float32": 67e12}


def _bound_ms(work, dtype):
    nbytes, flops = work
    return max(nbytes / HBM, flops / PEAK[dtype]) * 1e3


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,want", [
    # PERF.md §6: flash, stablelm-3b train (B 4, S = T = 1024, 32 of 80)
    ("flash train", 0.0250),
    # flash, recurrentgemma-9b prefill (S = T = 2100, window 2048, MQA 256)
    ("flash window", 0.0365),
    # flash, stablelm-3b chunk (S = 256 over a 512-padded prefix of 384)
    ("flash prefix", 0.00274),
    # the RG-LRU scan, recurrentgemma-9b (S 2100, W 4096, no state)
    ("rglru", 0.0308),
    # decode attention, whisper-medium cross (B 8, C 1500, 16 of 64)
    ("decode cross", 0.0147),
])
def test_kernel_work_gives_perfs_bounds(case, want):
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru import ops as lru
    if case == "flash train":
        q = _meta(4, 1024, 32, 80)
        work, dt = fa.flash_attention_work(q, q), "bfloat16"
    elif case == "flash window":
        work, dt = fa.flash_attention_work(
            _meta(1, 2100, 16, 256), _meta(1, 2100, 1, 256),
            window=2048), "bfloat16"
    elif case == "flash prefix":
        work, dt = fa.flash_attention_work(
            _meta(1, 256, 32, 80), _meta(1, 768, 32, 80), prefix_pad=512,
            prefix_len=384), "bfloat16"
    elif case == "rglru":
        work, dt = lru.rglru_scan_work(
            _meta(1, 2100, 4096, dtype=torch.float32)), "float32"
    else:
        work, dt = da.decode_attention_work(
            _meta(8, 1, 16, 64), _meta(8, 1500, 16, 64), 8 * 1500), \
            "bfloat16"
    assert round(_bound_ms(work, dt), 2 - int(np.floor(np.log10(want)))) \
        == pytest.approx(want)


def test_kept_pairs_count_the_mask():
    """The flash work's pairs and rows against the mask itself."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import keep_mask
    for S, T, kw in ((7, 7, {}), (5, 13, dict(prefix_pad=8, prefix_len=3)),
                     (9, 9, dict(window=3)), (4, 10, dict(causal=False)),
                     (6, 12, dict(prefix_pad=6, prefix_len=6))):
        keep = keep_mask(S, T, **kw)
        assert fa.kept_pairs(S, T, **kw) == (int(keep.sum()),
                                             int(keep.any(0).sum()))


def test_meta_calls_meter_the_work_and_launch_nothing():
    """On ``meta`` tensors every wrapper returns outputs of the kernel's
    shapes, hands its ``*_work`` to the meter and counts no launch."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.rglru import ops as lru
    from repro_torch.kernels.ssd import ops as ssd
    got = []
    prev = _build.METER
    _build.METER = lambda name, flops, nbytes, like: got.append(
        (name, flops, nbytes))
    launches = {f: f.launches for f in (fa.flash_attention,
                                        da.decode_attention,
                                        pa.paged_decode_attention)}
    try:
        q = _meta(2, 8, 4, 16)
        assert fa.flash_attention(q, q, q).shape == q.shape
        qd, kd = _meta(2, 1, 4, 16), _meta(2, 32, 2, 16)
        valid = _meta(2, 32, dtype=torch.bool)
        assert da.decode_attention(qd, kd, kd, valid).shape == qd.shape
        acc, ml = da.decode_attention_partial(qd, kd, kd, valid)
        assert da.decode_combine(acc, ml, torch.bfloat16).shape == qd.shape
        kq = _meta(2, 32, 2, 16, dtype=torch.int8)
        scale = _meta(2, 32, 2, dtype=torch.float32)
        assert da.decode_attention_int8(qd, kq, kq, scale, scale,
                                        valid).shape == qd.shape
        acc8, ml8 = da.decode_attention_int8_partial(qd, kq, kq, scale,
                                                     scale, valid)
        assert (acc8.shape, ml8.shape) == (acc.shape, ml.shape)
        # the shapes of the plain partials on the CPU
        assert (acc.shape, ml.shape) == ((2, 4, 1, 16), (2, 4, 1, 2))
        pool = _meta(9, 4, 2, 16)
        table = _meta(2, 3, dtype=torch.int32)
        assert pa.paged_decode_attention(
            qd, pool, pool, table, _meta(2, dtype=torch.int32)).shape \
            == qd.shape
        a = _meta(1, 5, 8, dtype=torch.float32)
        assert lru.rglru_scan(a, a).shape == a.shape
        x = _meta(1, 20, 2, 4, dtype=torch.float32)
        y, h = ssd.ssd_chunked(x, _meta(1, 20, 2, dtype=torch.float32),
                               _meta(2, dtype=torch.float32),
                               _meta(1, 20, 8, dtype=torch.float32),
                               _meta(1, 20, 8, dtype=torch.float32),
                               chunk=8)
        assert (y.shape, h.shape) == (x.shape, (1, 2, 4, 8))
    finally:
        _build.METER = prev
    assert [n for n, _, _ in got] == [
        "flash_attention", "decode_attention", "decode_attention_partial",
        "decode_combine", "decode_attention_int8",
        "decode_attention_int8_partial", "paged_decode_attention",
        "rglru_scan", "ssd_chunked"]
    assert got[0][1:] == fa.flash_attention_work(q, q)[::-1]
    n_valid = 2 * 32
    assert got[4][1:] == da.decode_attention_work(
        qd, kq, n_valid, int8=True)[::-1]
    assert got[5][1:] == da.decode_attention_work(
        qd, kq, n_valid, int8=True, n_split=1)[::-1]
    assert all(f > 0 and b > 0 for _, f, b in got)
    assert all(f.launches == n for f, n in launches.items())


def test_cache_specs_under_ulysses_equal_the_references():
    """``cache_pspecs`` of the contiguous cache under ``ulysses_sp``
    (qwen3-14b, yi-34b on the production meshes) leaf for leaf against
    the reference's."""
    from repro_torch.sharding import rules as R
    for name in ("qwen3-14b", "yi-34b", "qwen2.5-32b"):
        for shape, axes in (((16, 16), ("data", "model")),
                            ((2, 16, 16), ("pod", "data", "model"))):
            mesh = _FakeMesh(shape, axes)
            cfg, cfg_j = get_config(name), get_config_jax(name)
            rls = R.make_rules(mesh, cfg)
            assert rls.tp_strategy == "ulysses_sp"
            cache = build_model(cfg).init_cache(128, 32768, device="meta")
            got = R.cache_pspecs(rls, cache)
            ref_m = build_jax(cfg_j)
            want = rules_jax.cache_pspecs(
                rules_jax.make_rules(mesh, cfg_j),
                ref_m.init_cache(128, 32768, abstract=True))
            import jax
            flat_w = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: not isinstance(x, dict))[0]
            for path, w in flat_w:
                g = got
                for k in path:
                    g = g[k.key]
                assert tuple(g) == tuple(w), (name, path)
