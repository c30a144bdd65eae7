"""The parts of ``chip_smoke.py`` that run without a card: the rotation of
timed inputs past the L2 cache, the build report's parse of the ptxas
output, the kernel names and the HMMA counts of the SASS, the serve
phases' checks of the decode graph (its launch tally and the bit-equal
replay against an eager step), whisper-medium's decode byte floor, the
summary line's rows, flash's NaN-tail check, and the trace and profile
reports."""

import collections
import json
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 239 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    24 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 72 registers, 4096 bytes smem, 384 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z3fooPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
\t\tFunction : _Z3barPf
        /*0000*/                   FFMA R1, R2, R3, R1 ;
"""


def test_rotations_exceed_the_l2():
    """Inputs under the L2 are cloned until all copies together exceed
    it; other arguments are passed through as they are."""
    x = torch.zeros(1000, 1000)                     # 4 MB
    copies = chip_smoke.rotations((x, None, 3))
    assert sum(c[0].numel() * 4 for c in copies) > chip_smoke.L2_BYTES
    assert copies[0][0] is x
    assert all(c[0] is not x for c in copies[1:])
    assert all(c[1] is None and c[2] == 3 for c in copies)


def test_rotations_leave_inputs_past_the_l2_alone():
    x = torch.zeros(13_000_000)                     # 52 MB
    assert len(chip_smoke.rotations((x,))) == 1


def test_rotations_stop_at_the_cap():
    """Tiny inputs stop at MAX_COPIES, so the timed calls stay within the
    card's launch queue."""
    assert len(chip_smoke.rotations((torch.zeros(4),))) \
        == chip_smoke.MAX_COPIES


def test_ptxas_resources_per_kernel(monkeypatch):
    monkeypatch.setattr(chip_smoke, "demangle", lambda names: names)
    rows = chip_smoke.ptxas_resources(PTXAS)
    assert [(r["mangled"], r["registers"], r["smem_bytes"], r["spill_bytes"])
            for r in rows] == [("_Z3fooPf", 239, 0, 0),
                               ("_Z3barPf", 72, 4096, 40)]


def test_hmma_counts_per_kernel(monkeypatch):
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=SASS))
    assert chip_smoke.hmma_counts("cuobjdump", "lib.so") \
        == {"_Z3fooPf": 2, "_Z3barPf": 0}


@pytest.mark.parametrize("name,want", [
    ("void <unnamed>::decode_mma_kernel<(int)256>(__nv_bfloat16 const*, int)",
     "decode_mma_kernel<(int)256>"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 3>(float const*)",
     "flash_fwd_kernel<float, 3>"),
    ("(anonymous namespace)::rglru_scan_kernel(float const*, int)",
     "rglru_scan_kernel"),
    ("_Z3fooPf", "_Z3fooPf"),
])
def test_strip_arguments(name, want):
    assert chip_smoke.strip_arguments(name) == want


def test_paged_kv_keys_count_the_kept_rows():
    """The pool rows the paged bound counts: each kept position's row
    once, through the table, from the window's start (counted from the
    uncapped length) to the table's reach; a retired row (all page 0)
    reaches only the scratch page."""
    table = torch.tensor([[3, 1], [0, 0]], dtype=torch.int32)
    keys = chip_smoke.paged_kv_keys(table, [6, 9], ps=4)
    assert keys.tolist() == [0, 1, 2, 3, 4, 5, 12, 13, 14, 15]
    keys = chip_smoke.paged_kv_keys(table, [6, 0], ps=4, window=3)
    assert keys.tolist() == [4, 5, 15]
    assert chip_smoke.paged_kv_keys(table, [10, 0], ps=4,
                                    window=3).tolist() == [7]
    assert chip_smoke.paged_kv_keys(table, [10, 0], ps=4,
                                    window=1).tolist() == []


def test_paged_nan_elsewhere_leaves_read_rows_alone():
    """NaN lands in every pool row that no kept position reads, and
    nowhere else."""
    P, ps = 4, 4
    kp = torch.arange(P * ps * 2 * 3, dtype=torch.float32).reshape(
        P, ps, 2, 3)
    table = torch.tensor([[3, 1]], dtype=torch.int32)
    kn, vn = chip_smoke.paged_nan_elsewhere(kp, kp.clone(), table, [6],
                                            window=4)
    read = torch.zeros(P * ps, dtype=torch.bool)
    read[[14, 15, 4, 5]] = True
    for t in (kn, vn):
        flat = t.view(P * ps, -1)
        assert torch.equal(flat[read], kp.view(P * ps, -1)[read])
        assert flat[~read].isnan().all()
    assert not kp.isnan().any()


def test_wrapper_times_sum_a_wrappers_functions():
    """A wrapper that launches several CUDA functions a call is reported as
    the sum of their device time over its calls; other kernels stay out."""
    rows = [(100.0, 4, "void (anonymous namespace)::ssd_state_mma_kernel("
                       "float const*)"),
            (50.0, 4, "ssd_pass_kernel(float const*)"),
            (200.0, 4, "ssd_out_mma_kernel(float const*)"),
            (10.0, 3, "flash_mma_kernel<128>(float const*)")]
    got = chip_smoke.wrapper_times(rows)
    assert got == {"ssd_chunk_scan": {"calls": 4,
                                      "per_call_ms": 350.0 / 1e3 / 4}}
    assert chip_smoke.wrapper_times(rows[3:]) == {}


def test_device_rows_read_either_profiler_field():
    """Only CUDA entries with device time, from the newer field or the
    older one, the most first."""
    def entry(key, dev_type, count, **dev):
        return types.SimpleNamespace(key=key, count=count,
                                     device_type=dev_type, **dev)
    prof = types.SimpleNamespace(key_averages=lambda: [
        entry("a_kernel", "DeviceType.CUDA", 2, self_device_time_total=5.0),
        entry("b_kernel", "DeviceType.CUDA", 1, self_cuda_time_total=9.0),
        entry("cudaLaunchKernel", "DeviceType.CPU", 3,
              self_device_time_total=0.0),
        entry("idle_kernel", "DeviceType.CUDA", 4,
              self_device_time_total=0.0)])
    assert chip_smoke.device_rows(prof) == [(9.0, 1, "b_kernel"),
                                            (5.0, 2, "a_kernel")]


def test_device_rows_leave_out_the_backward_ranges():
    """A train phase's ``record_function`` range, listed by the profiler
    as a device entry spanning its kernels, is not a kernel: busy time
    counts its kernels once."""
    prof = types.SimpleNamespace(key_averages=lambda: [
        types.SimpleNamespace(key=chip_smoke.TRAIN_RANGE + "optimizer",
                              count=2, device_type="DeviceType.CUDA",
                              self_device_time_total=9.0),
        types.SimpleNamespace(key="sgemm", count=2,
                              device_type="DeviceType.CUDA",
                              self_device_time_total=5.0)])
    assert chip_smoke.device_rows(prof) == [(5.0, 2, "sgemm")]


def test_by_function_counts_each_row_once():
    rows = [(10.0, 2, "ssd_out_mma_kernel(float)"),
            (4.0, 2, "ssd_out_mma_kernel(int)"),
            (1.0, 1, "other_kernel")]
    assert chip_smoke.by_function(rows, ("ssd_out_mma_kernel",
                                         "ssd_out")) == {
        "ssd_out_mma_kernel": (14.0, 4)}


def test_ssd_needed_flops_counts_the_nonzero_band():
    """A log decay of -30 a step leaves weights nonzero in float32 for
    segments of at most 3 steps (-90 > ln 2^-150 > -120): each step pairs
    with itself and the 3 before it, 4 steps reach the final state, and
    an initial state reaches the first 3 steps only."""
    S, H, N, P = 16, 2, 4, 2
    da = torch.full((S, H), -30.0)
    pairs = sum(min(t + 1, 4) for t in range(S))           # 58
    want = H * (pairs * 2 * P + 4 * 2 * N * P) + pairs * 2 * N
    assert chip_smoke.ssd_needed_flops(da, False, N, P) == want
    assert chip_smoke.ssd_needed_flops(da, True, N, P) \
        == want + H * 3 * 2 * N * P
    assert want < chip_smoke.ssd_min_flops(S, H, P, N, False)


def test_ssd_needed_flops_takes_the_chunked_form_under_weak_decay():
    """With no decay every pair counts, and the chunked form needs fewer
    operations than the quadratic one."""
    S, H, N, P = 64, 2, 8, 4
    for with_h0 in (False, True):
        assert chip_smoke.ssd_needed_flops(
            torch.zeros(S, H), with_h0, N, P) \
            == chip_smoke.ssd_min_flops(S, H, P, N, with_h0)


def _graph(replays, per_replay, captures=1):
    return {"captures": captures, "replays": replays,
            "launches_per_replay": per_replay, "capture_ms": 50.0}


def test_check_graph_holds_the_launch_tally():
    """After ``steps`` decode steps the graph was captured once, after the
    eager first step, and replayed for the rest, each replay counting one
    eager step's launches: with the first step's L that is L × steps, the
    serve phases' exact counts."""
    L, steps = 32, 38
    got = chip_smoke.check_graph("serve", _graph(steps - 1,
                                                 {"paged": L}),
                                 steps, {"paged": L, "flash": 0})
    assert got["replays"] * got["launches_per_replay"]["paged"] + L \
        == L * steps
    # a model whose decode runs no kernel replays an empty tally
    chip_smoke.check_graph("ssm", _graph(steps - 1, {}), steps,
                           {"ssd_chunk_scan": 0})
    for bad in (None, _graph(steps, {"paged": L}),
                _graph(steps - 1, {"paged": L - 1}),
                _graph(steps - 1, {"paged": L}, captures=2),
                _graph(steps - 1, {"paged": L, "flash": 1})):
        with pytest.raises(SystemExit, match="decode graph"):
            chip_smoke.check_graph("serve", bad, steps, {"paged": L})


def test_hold_bit_equal_fails_on_a_differing_tensor():
    """The graph-vs-eager check passes equal tensors (NaN where both have
    NaN) and fails on one differing element, a NaN in one place only, or
    a shape or dtype that differs."""
    a = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
    a[1, 2] = float("nan")
    i8 = torch.arange(6, dtype=torch.int8)
    assert chip_smoke.hold_bit_equal("x", [("a", a, a.clone()),
                                           ("i8", i8, i8.clone())]) \
        == {"max_abs_diff": 0.0, "tensors": 2}
    b = a.clone()
    b[2, 3] += 1
    with pytest.raises(SystemExit, match="differs .* by up to 1.0"):
        chip_smoke.hold_bit_equal("x", [("a", a, a.clone()), ("b", a, b)])
    c = a.clone()
    c[0, 0] = float("nan")
    with pytest.raises(SystemExit, match="NaN"):
        chip_smoke.hold_bit_equal("x", [("c", a, c)])
    j8 = i8.clone()
    j8[5] = 7
    with pytest.raises(SystemExit, match="differs"):
        chip_smoke.hold_bit_equal("x", [("i8", i8, j8)])
    for other in (a.float(), a[:2]):
        with pytest.raises(SystemExit):
            chip_smoke.hold_bit_equal("x", [("a", a, other)])


def test_clone_tree_copies_dicts_and_tuples():
    """The graph check's clone of an engine's state (cache tree and input
    buffers) copies every tensor and keeps the tree's shape."""
    from repro_torch.serving.decode_graph import tensors

    state = ({"layers": {"b0": {"k": torch.zeros(2), "v": torch.ones(2)}}},
             torch.full((3,), 2.0))
    copy = chip_smoke.clone_tree(state)
    assert isinstance(copy, tuple)
    flat, flat_copy = tensors(state), tensors(copy)
    assert [t.tolist() for t in flat] == [t.tolist() for t in flat_copy] \
        == [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0, 2.0]]
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(flat, flat_copy))


def test_record_routing_logs_each_moe_call():
    """The routing patch logs each MoE call's expert sets, the K-th −
    (K+1)-th probability gaps and the drops, and leaves the output
    alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("olmoe-1b-7b").reduced().replace(
        moe_capacity_factor=1.25)
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.randn(*s, generator=gen) / 8 for k, s in {
        "router": (64, 8), "w_gate": (8, 64, 128), "w_up": (8, 64, 128),
        "w_down": (8, 128, 64)}.items()}
    x = torch.randn(2, 12, 64, generator=gen)
    log = []
    with chip_smoke.record_routing(log):
        y, _ = moe.apply_moe(cfg, p, x)
    assert moe.apply_moe(cfg, p, x)[0].equal(y) and len(log) == 1
    probs, _, idx = moe.route(cfg, p, x.reshape(24, 64))
    assert log[0]["experts"].equal(idx.sort(-1).values)
    top = probs.sort(-1, descending=True).values
    assert log[0]["gap"].equal(top[:, 1] - top[:, 2])
    load = torch.bincount(idx.reshape(-1), minlength=8)
    assert log[0]["dropped"] == int((load - 7).clamp(min=0).sum())
    assert log[0]["max_load"] == int(load.max())


def test_routing_diffs_order_by_position():
    """Tokens whose expert set differs, in any layer, by position; the
    gap comes from the second run."""
    def entry(sets, gaps):
        return {"experts": torch.tensor(sets), "gap": torch.tensor(gaps)}
    kern = [entry([[0, 1], [2, 3], [1, 4]], [0.1, 0.2, 0.3]),
            entry([[0, 1], [2, 3], [1, 4]], [0.1, 0.2, 0.3])]
    plain = [entry([[0, 1], [2, 3], [1, 5]], [0.1, 0.2, 1e-7]),
             entry([[0, 1], [2, 4], [1, 4]], [0.1, 2e-7, 0.3])]
    got = chip_smoke.routing_diffs(kern, plain)
    assert [(j, layer) for j, layer, _ in got] == [(1, 1), (2, 0)]
    assert [g for _, _, g in got] == pytest.approx([2e-7, 1e-7])
    assert chip_smoke.routing_diffs(kern, kern) == []


def test_encdec_step_floor_counts_what_a_step_reads():
    """whisper-medium's decode step at B = 8: the decoder's weights but
    the cross-attention's K/V projections, the tied head, the 24 layers'
    cross memory of 1500 frames and the mean valid self rows, in bf16."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-medium")
    f = chip_smoke.encdec_step_floor(cfg, 8, 64)
    D, Fd, L = 1024, 4096, 24
    layer = 6 * D * D + 2 * D * Fd + Fd + D + 6 * D
    assert f["decoder_weights_gb"] == 2 * (L * layer + 2 * D) / 1e9
    assert f["tied_head_gb"] == 2 * 51968 * D / 1e9
    assert f["cross_kv_gb"] == 2 * 2 * L * 8 * 1500 * D / 1e9
    assert f["self_kv_gb"] == 2 * 2 * L * 8 * (4 + 65 / 2) * D / 1e9
    assert abs(f["floor_ms"] - f["total_gb"] * 1e9
               / chip_smoke.HBM_BYTES_PER_S * 1e3) < 1e-12
    assert 0.59 < f["floor_ms"] < 0.62


def _key(**fields):
    return tuple(fields.items())


def test_summary_rows_carry_the_wave_launches():
    """The summary line lists each kernel's rows by what tells them
    apart; each row carries the main paths' launches counted at its
    launch key, 0 where none was launched at that key."""
    enc_key = dict(dtype="bfloat16", B=8, S=1500, T=1500, H=16, KVH=16,
                   d=64, causal=False, window=0, prefix_pad=0, prefix_len=0)
    shapes = {"flash_attention": collections.Counter({
        _key(**enc_key): 24, _key(**{**enc_key, "S": 4}): 24})}
    times = dict(ms=1.0, plain_ms=2.0, library_ms=None, bound_ms=0.5,
                 bound_by="bytes", max_abs_err=0.0, call_ms=9.0)
    enc = dict(kernel="flash_attention", shape="whisper-medium",
               case="encoder", dtype="bfloat16", S=1500, T=1500, B=8,
               prefix_pad=0, prefix_len=0, H=16, launch_key=enc_key,
               **times)
    row = chip_smoke.summary_row(enc, shapes)
    assert row == {"shape": "whisper-medium", "case": "encoder",
                   "dtype": "bfloat16", "B": 8, "S": 1500, "T": 1500,
                   "prefix_pad": 0, "prefix_len": 0, "ms": 1.0,
                   "plain_ms": 2.0, "library_ms": None, "bound_ms": 0.5,
                   "bound_by": "bytes", "max_abs_err": 0.0,
                   "main_path_launches": 24}
    for other in ({**enc_key, "dtype": "float32"},
                  {**enc_key, "causal": True}, {**enc_key, "S": 5}):
        assert chip_smoke.summary_row({**enc, "launch_key": other},
                                      shapes)["main_path_launches"] == 0
    assert chip_smoke.summary_row(
        {**enc, "kernel": "decode_attention"},
        shapes)["main_path_launches"] == 0


def test_launch_tables_count_by_key_and_add_up():
    """The wrappers' counters count every launch in all and by its key;
    zeroing clears both; tables of two paths add key by key; the printed
    table names each key's fields, most launched first."""
    from repro_torch.kernels import _build

    @_build.counted
    def wrapper(key):
        _build.count_launch(wrapper, key)

    counters = {"w": wrapper}
    a, b = _key(S=4, causal=True), _key(S=1500, causal=False)
    for key in (a, b, b):
        wrapper(key)
    launches, shapes = chip_smoke.read_launches(counters)
    assert launches == {"w": 3} and shapes == {"w": {a: 1, b: 2}}
    chip_smoke.zero_launches(counters)
    assert chip_smoke.read_launches(counters) == ({"w": 0}, {})
    total = chip_smoke.add_shapes(shapes, {"w": collections.Counter({a: 5}),
                                           "v": collections.Counter({b: 1})})
    assert total == {"w": {a: 6, b: 2}, "v": {b: 1}}
    assert chip_smoke.shape_table(total) == {
        "v": [{"S": 1500, "causal": False, "launches": 1}],
        "w": [{"S": 4, "causal": True, "launches": 6},
              {"S": 1500, "causal": False, "launches": 2}]}


def test_flash_tail_nan_check_catches_a_read_past_the_end(monkeypatch):
    """The tail check hands the wrapper views whose memory is followed by
    NaN: a function that reads one element past q's last row fails it, a
    function that reads only its inputs passes."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q = torch.randn(2, 3, 2, 4)
    k = torch.randn(2, 5, 2, 4)
    monkeypatch.setattr(fa_ops, "flash_attention",
                        lambda q, k, v, **kw: q + k.sum())
    out = q + k.sum()
    chip_smoke.check_flash_tail_nan("ok", q, k, k.clone(), {}, out)

    def leaky(q, k, v, **kw):
        past = torch.as_strided(q, (1,), (1,), q.storage_offset() + q.numel())
        return q + k.sum() + past
    monkeypatch.setattr(fa_ops, "flash_attention", leaky)
    with pytest.raises(SystemExit, match="NaN past the last rows"):
        chip_smoke.check_flash_tail_nan("leaky", q, k, k.clone(), {}, out)


def test_trace_report_segments_sum_to_the_wall(monkeypatch, tmp_path):
    from repro_torch import obs
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    spans = [obs.Span(name="request", cat="serving.request", t0=0.0, t1=2.0,
                      span_id=1),
             obs.Span(name="decode.step", cat="serving.decode", t0=0.5,
                      t1=0.75, span_id=2, parent_id=1),
             obs.Span(name="decode.step", cat="serving.decode", t0=3.0,
                      t1=3.5, span_id=3)]
    got = chip_smoke.trace_report(spans, "trace.txt")
    assert got["wall_ms"] == 3500.0 and got["segments_ms"] == 3500.0
    assert got["idle_ms"] == 1000.0
    comps = {c["component"]: c for c in got["critical_path"]}
    assert comps["serving.decode:decode.step"]["ms"] == 750.0
    assert comps["serving.request:request"]["ms"] == 1750.0
    assert got["busy_ms"] == 2750.0 and got["ideal_makespan_ms"] == 0.0
    assert "critical path" in (tmp_path / "trace.txt").read_text()
    with pytest.raises(SystemExit, match="segments"):
        chip_smoke.trace_report([], "trace.txt")


def test_profile_report_reads_busy_share_and_port_kernels(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    entry = lambda key, count, us: types.SimpleNamespace(  # noqa: E731
        key=key, count=count, device_type="DeviceType.CUDA",
        self_device_time_total=us)
    prof = types.SimpleNamespace(key_averages=lambda: [
        entry("flash_mma_kernel<64>(x)", 24, 600.0),
        entry("ampere_bf16_gemm", 100, 1400.0)])
    got = chip_smoke.profile_report(prof, 4000.0, "p.txt")
    assert got["device_busy_ms"] == 2.0 and got["device_busy_share"] == 0.5
    assert [k["name"] for k in got["port_kernels"]] \
        == ["flash_mma_kernel<64>(x)"]
    assert got["port_kernels"][0]["per_call_ms"] == 0.6 / 24
    assert (tmp_path / "p.txt").read_text().count("\n") == 2
    empty = types.SimpleNamespace(key_averages=lambda: [])
    assert chip_smoke.profile_report(empty, 1.0, "q.txt") is None


# ---------------------------------------------------------------------------
# the train phases


def test_train_phases_parse():
    """The five train phases, the fleet phase, the tensor-parallel,
    all-reduce, tensor-parallel families and fallbacks phases, the two
    sharded train phases and the PopPy programs' phase are phases of the
    script, in this order (the fallbacks phase right after the families
    phase, the layouts' train phase right after ``train_tp``): ``--phases`` takes
    them (and without a card the script stops before running any), and
    an unknown name is refused."""
    train = ("train", "train_ssm", "train_hybrid", "train_moe",
             "train_encdec")
    assert chip_smoke.PHASES[-13:] == ("train", "train_ssm",
                                       "train_hybrid", "serve_fleet",
                                       "train_moe", "train_encdec",
                                       "serve_tp", "ef_allreduce",
                                       "serve_tp_families",
                                       "serve_tp_fallbacks", "train_tp",
                                       "train_tp_layouts", "poppy_apps")
    assert tuple(chip_smoke.TRAIN_CASES) == train
    assert set(train) < set(chip_smoke.PHASES)
    if not torch.cuda.is_available():
        assert chip_smoke.main(["--phases", ",".join(train)
                                + ",serve_fleet,serve_tp,ef_allreduce,"
                                "serve_tp_families,serve_tp_fallbacks,"
                                "train_tp,train_tp_layouts,poppy_apps"]) \
            == 2
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phases", "train,train_vlm"])


def test_train_counts_follow_the_layer_groups():
    """Launches and backward calls a train step makes, from the layer
    groups: remat runs each group's kernels twice, the tail blocks once,
    and each RG-LRU block once more for its reversed scan."""
    from repro_torch.configs import get_config
    stablelm = get_config("stablelm-3b")
    assert chip_smoke.train_counts(stablelm) == (
        {"flash_attention": 64}, {"flash_attention": 32})
    assert chip_smoke.train_counts(get_config("mamba2-2.7b")) == (
        {"ssd_chunk_scan": 128}, {"ssd_chunk_scan": 64})
    rg = get_config("recurrentgemma-9b")
    assert chip_smoke.train_counts(rg.replace(num_layers=3)) == (
        {"flash_attention": 2, "rglru_scan": 6},
        {"flash_attention": 1, "rglru_scan": 2})
    # all 38 blocks: 12 groups and a tail of two RG-LRU blocks
    assert chip_smoke.train_counts(rg) == (
        {"flash_attention": 24, "rglru_scan": 48 + 2 + 26},
        {"flash_attention": 12, "rglru_scan": 26})
    assert chip_smoke.train_counts(stablelm.replace(remat="none"))[0] \
        == {"flash_attention": 32}
    # MoE layers are attention layers: the train_moe phase's 2 of 16
    assert chip_smoke.train_counts(
        get_config("olmoe-1b-7b").replace(num_layers=2)) == (
        {"flash_attention": 4}, {"flash_attention": 2})
    # whisper-medium: an encoder layer's self-attention, a decoder layer's
    # self- and cross-attention, each run again by remat
    assert chip_smoke.train_counts(get_config("whisper-medium")) == (
        {"flash_attention": 2 * (24 + 48)}, {"flash_attention": 24 + 48})
    assert chip_smoke.train_counts(get_config("whisper-medium").replace(
        remat="none"))[0] == {"flash_attention": 72}


def test_train_model_flops_count_what_each_token_meets():
    """``mfu``'s numerator: every parameter over every token of a dense
    model; the experts at top-k / experts; the encoder and the cross K/V
    projections over the frames."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    dense = build_model(get_config("stablelm-3b"))
    assert chip_smoke.train_model_flops(dense, 4, 1024) \
        == 6 * dense.num_params() * 4 * 1024
    moe_cfg = get_config("olmoe-1b-7b").replace(num_layers=2)
    moe = build_model(moe_cfg)
    experts = 2 * 3 * 64 * 2048 * 1024
    assert chip_smoke.train_model_flops(moe, 4, 1024) == pytest.approx(
        6 * (moe.num_params() - experts * (1 - 8 / 64)) * 4 * 1024)
    ed = build_model(get_config("whisper-medium"))
    assert ed.num_params() == 758_353_920
    enc = sum(n for path, n in chip_smoke.schema_leaves(ed.schema())
              if path[0] in ("enc_layers", "enc_final_norm"))
    cross_kv = 24 * 2 * 1024 * 1024
    assert chip_smoke.train_model_flops(ed, 4, 448) == 6 * (
        (enc + cross_kv) * 4 * 1500 + (ed.num_params() - enc - cross_kv)
        * 4 * 448)


@pytest.fixture()
def cpu_chip_smoke(monkeypatch, tmp_path):
    """A copy of the script with every ``"cuda"`` read as ``"cpu"``, the
    CUDA timers and memory counters stubbed, its output directory and the
    checkpoint directory under ``tmp_path``, and each trained kernel's
    forward counted as a launch on the CPU (the plain versions count
    nothing): a rehearsal of the train phases without a card."""
    from pathlib import Path

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru import ops as lru
    from repro_torch.kernels.ssd import ops as ssd

    src = Path(chip_smoke.__file__).read_text().replace('"cuda"', '"cpu"')
    # the copy lives in a file and in sys.modules: ``@poppy`` reads its
    # programs' source, and a process-offloaded external is imported by
    # module name in the worker
    path = tmp_path / "chip_smoke_cpu.py"
    path.write_text(src)
    mod = types.ModuleType("chip_smoke_cpu")
    mod.__file__ = str(path)
    monkeypatch.setitem(sys.modules, "chip_smoke_cpu", mod)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    mod.card = lambda: "CPU rehearsal"
    mod.OUT_DIR = tmp_path / "out"
    mod.TRAIN_CKPT_DIR = tmp_path / "ckpt"

    def counted(module, wrapper, key):
        real = module._forward

        def forward(*a, **k):
            _build.count_launch(wrapper, key(*a))
            return real(*a, **k)
        monkeypatch.setattr(module, "_forward", forward)

    counted(fa, fa.flash_attention, lambda q, k, v, causal, window, *_:
            fa.launch_key(q, k, causal=causal, window=window))
    counted(lru, lru.rglru_scan, lambda a, b, h0=None: lru.launch_key(a, h0))
    counted(ssd, ssd.ssd_chunked,
            lambda xh, dt, a_log, B, C, chunk, h0=None:
            ssd.launch_key(xh, B, h0))
    return mod


def test_train_phases_rehearsed_on_the_cpu(cpu_chip_smoke, monkeypatch,
                                           capsys):
    """Each train phase at reduced width and depth: exact launches and
    backward calls every step, no plain forward on the device, the loss
    falling, the checkpoint read back bit-equal and the gradient check
    held, in one JSON line with the card beside the numbers."""
    import json

    import repro_torch.configs as configs
    real = configs.get_config

    def reduced(name):
        cfg = real(name).reduced()
        return cfg.replace(num_layers=38, attn_window=8) \
            if name == "recurrentgemma-9b" else cfg
    monkeypatch.setattr(configs, "get_config", reduced)
    mod = cpu_chip_smoke
    mod.TRAIN_CASES = {
        "train": dict(arch="stablelm-3b", batch=2, seq=16, check_layers=2),
        "train_ssm": dict(arch="mamba2-2.7b", batch=2, seq=16,
                          check_layers=2),
        "train_hybrid": dict(arch="recurrentgemma-9b", batch=1, seq=20,
                             layers=3, check_layers=3,
                             why=chip_smoke.TRAIN_CASES["train_hybrid"][
                                 "why"])}
    for phase, want in (("train", {"flash_attention": 4}),
                        ("train_ssm", {"ssd_chunk_scan": 4}),
                        ("train_hybrid", {"flash_attention": 2,
                                          "rglru_scan": 6})):
        launches, shapes = mod.phase_train(phase, 0)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["phase"] == phase and line["card"] == "CPU rehearsal"
        assert line["launches_per_step"] == want
        assert {k: v for k, v in launches.items() if v} == {
            k: v * mod.TRAIN_STEPS for k, v in want.items()}
        assert line["backward_calls_per_step"] == {
            k: v // 2 if k != "rglru_scan" else v // 3
            for k, v in want.items()}
        assert len(line["losses"]) == mod.TRAIN_STEPS
        assert line["losses"][-1] < line["losses"][0]
        assert line["checkpoint"]["bit_equal"]
        assert line["checkpoint"]["step"] == mod.TRAIN_STEPS + 1
        assert line["grads_vs_plain"]["float32"]["worst_grad_rel_l2"] \
            <= line["grads_vs_plain"]["float32"]["tol"]
        assert line["reduced"] == ([] if phase != "train_hybrid" else [
            line["reduced"][0]]) and line["layers"] == (
            3 if phase == "train_hybrid" else 2)
        assert not (mod.TRAIN_CKPT_DIR).exists()


@pytest.mark.parametrize("phase", ["train_moe", "train_encdec"])
def test_moe_and_encdec_train_phases_rehearsed_on_the_cpu(
        cpu_chip_smoke, monkeypatch, capsys, phase):
    """train_moe (reduced olmoe at 3 layers, cut to 2) and train_encdec
    (reduced whisper, 2 + 2 layers over 16 frames): the train phases'
    checks, the MoE gradient check holding the first batch whose routing
    agrees (on the CPU both paths are the plain versions, so the first),
    and ``mfu`` from :func:`train_model_flops`."""
    import json

    import repro_torch.configs as configs
    real = configs.get_config

    def reduced(name):
        cfg = real(name).reduced()
        return cfg.replace(num_layers=3) if name == "olmoe-1b-7b" else cfg
    monkeypatch.setattr(configs, "get_config", reduced)
    mod = cpu_chip_smoke
    mod.TRAIN_CASES = {
        "train_moe": dict(arch="olmoe-1b-7b", batch=2, seq=16, layers=2,
                          check_layers=2,
                          why=chip_smoke.TRAIN_CASES["train_moe"]["why"]),
        "train_encdec": dict(arch="whisper-medium", batch=2, seq=16,
                             check_layers=2)}
    want, vjp = {"train_moe": ({"flash_attention": 4},
                               {"flash_attention": 2}),
                 "train_encdec": ({"flash_attention": 12},
                                  {"flash_attention": 6})}[phase]
    launches, shapes = mod.phase_train(phase, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == phase and line["card"] == "CPU rehearsal"
    assert line["launches_per_step"] == want
    assert line["backward_calls_per_step"] == vjp
    assert {k: v for k, v in launches.items() if v} == {
        k: v * mod.TRAIN_STEPS for k, v in want.items()}
    assert line["losses"][-1] < line["losses"][0]
    assert line["checkpoint"]["bit_equal"]
    f32 = line["grads_vs_plain"]["float32"]
    assert f32["worst_grad_rel_l2"] <= f32["tol"]
    if phase == "train_moe":
        assert line["layers"] == 2 and "~111 GB" in line["reduced"][0]
        assert f32["batch"] == 0 and f32["batches_with_routing_diffs"] == []
        assert f32["moe_calls"] == 2 * 2     # forward and remat, 2 layers
        assert line["grads_vs_plain"]["bfloat16"]["routing_diffs"] == 0
    else:
        assert line["layers"] == 2 and line["reduced"] == []
        assert "encoder_frames" not in line
    assert line["mfu"] == line["model_flops_per_step"] \
        / line["step_median_s"] / mod.PEAK_FLOPS["bfloat16"]


def test_moe_grads_check_skips_a_batch_whose_routing_differs(
        cpu_chip_smoke, monkeypatch):
    """A batch where the two paths route a token to different experts is
    reported, not held; the next batch, routed alike, is held."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.data import LMDataset
    mod = cpu_chip_smoke
    cfg = get_config("olmoe-1b-7b").reduced().replace(remat="full")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batches = [mod.train_device_batch(cfg, LMDataset(
        vocab_size=cfg.vocab_size, batch_size=1, seq_len=8,
        seed=0).batch(i)) for i in range(2)]
    real = mod.routing_diffs
    calls = []

    def tipped_first(kern, plain):
        calls.append(len(kern))
        return [(3, 0, 1e-9)] if len(calls) == 1 else real(kern, plain)
    monkeypatch.setattr(mod, "routing_diffs", tipped_first)
    got = mod.moe_grads_vs_plain(model, params, batches, 1e-4, "moe")
    assert got["batch"] == 1
    assert got["batches_with_routing_diffs"] == [{
        "batch": 0, "tokens_differing": 1,
        "first_diffs": [{"position": 3, "call": 0, "gap": 1e-9}]}]
    monkeypatch.setattr(mod, "routing_diffs", lambda k, p: [(0, 0, 0.0)])
    with pytest.raises(SystemExit):
        mod.moe_grads_vs_plain(model, params, batches, 1e-4, "moe")
    # printed only (bf16): the first batch, its differing tokens counted
    got = mod.moe_grads_vs_plain(model, params, batches, None, "moe")
    assert got["batch"] == 0 and got["routing_diffs"] == 1


def test_serve_fleet_rehearsed_on_the_cpu(cpu_chip_smoke, monkeypatch,
                                          capsys):
    """The fleet phase on a tiny stablelm: the three fleets' tokens held
    to the single engine's, affinity warmer than least-outstanding,
    exact launches summed over every replica (each CPU call of a kernel's
    plain version counted as its launch), and the generate_batch wave's
    prefix counts on the fleet's stats.  The CPU engine captures no
    decode graph, so the graph check is recorded instead."""
    import json

    import repro_torch.configs as configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops as pa
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda name: real(name).reduced())
    ref = pa.paged_decode_attention_ref

    def counted(q, kp, vp, table, lengths, *, window=0):
        _build.count_launch(pa.paged_decode_attention,
                            pa.launch_key(q, kp, table, window=window))
        return ref(q, kp, vp, table, lengths, window=window)
    monkeypatch.setattr(pa, "paged_decode_attention_ref", counted)
    mod = cpu_chip_smoke
    graphs = []

    def no_graph(label, graph, steps, per_step):
        assert graph is None and steps > 0
        graphs.append(label)
        return {"steps": steps}
    mod.check_graph = no_graph
    launches, shapes = mod.phase_serve_fleet(0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_fleet" and line["layers"] == 2
    fleets = line["fleets"]
    assert list(fleets) == ["one_replica", "affinity", "least_outstanding"]
    # one replica holds every session's prefix: the paged radix trie keys
    # a node by its first page, so the sessions' prompts, which share
    # their first page's leading tokens, are siblings
    assert fleets["one_replica"]["warm_share"] == 1.0
    assert fleets["affinity"]["warm_share"] == 1.0
    assert fleets["least_outstanding"]["warm_share"] == 0.25
    assert fleets["one_replica"]["drain_ratio_vs_one_replica"] == 1.0
    assert len(graphs) == 1 + 4 + 4
    steps = sum(e["steps"] for f in fleets.values()
                for e in f["engine_stats"].values())
    chunks = sum(e["prefill_chunks"] for f in fleets.values()
                 for e in f["engine_stats"].values())
    assert {k: v for k, v in launches.items() if v} == {
        "paged_decode_attention": 2 * steps, "flash_attention": 2 * chunks}
    assert line["generate_batch_wave"]["batches"] == 1
    assert line["generate_batch_wave"]["elements"] == 4
    for f in fleets.values():
        assert sum(f["routed"].values()) == 4 + 16


def test_train_tp_rehearsed_on_the_cpu(cpu_chip_smoke, monkeypatch,
                                      capsys):
    """train_tp at reduced width: stablelm at (1, 1), (2, 1), (1, 2) and
    (2, 2) and qwen3 under ulysses_sp at (1, 1) and (1, 4), every
    coordinate on the CPU; flash launches a step held to dp × tp ×
    layers × 2, the float32 check against (1, 1) held, the collectives
    printed by kind."""
    import json

    import repro_torch.configs as configs
    real = configs.get_config

    def reduced(name):
        cfg = real(name).reduced()
        return cfg.replace(tp_strategy="ulysses_sp") \
            if name == "qwen3-14b" else cfg
    monkeypatch.setattr(configs, "get_config", reduced)
    mod = cpu_chip_smoke
    mod.TRAIN_TP = dict(chip_smoke.TRAIN_TP, batch=2, seq=16, layers=2)
    mod.TRAIN_TP_ULYSSES = dict(chip_smoke.TRAIN_TP_ULYSSES, seq=16,
                                meshes=((1, 1), (1, 4)))
    mod.TRAIN_TP_STEPS = 2
    launches, _ = mod.phase_train_tp(0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "train_tp" and line["card"] == "CPU rehearsal"
    dense, uly = line["cases"]
    got = [(r["mesh"], r["tp_strategy"], r["flash_launches_per_step"])
           for r in dense["bfloat16"]["meshes"]]
    assert got == [([1, 1], "heads", 4), ([2, 1], "heads", 8),
                   ([1, 2], "heads", 8), ([2, 2], "heads", 16)]
    # the rehearsal's reduced qwen3 has 4 heads, so its config sets the
    # strategy (the full one's 40 heads make make_rules pick it at 16)
    assert [r["tp_strategy"] for r in uly["bfloat16"]["meshes"]] == [
        "ulysses_sp", "ulysses_sp"]
    for case in (dense, uly):
        for r in case["float32"]["meshes"][1:]:
            assert r["worst_grad_rel_l2_vs_1x1"] <= line["f32_tol"]
            assert r["loss_rel_err_vs_1x1"] <= line["f32_tol"]
        for r in case["bfloat16"]["meshes"]:
            assert len(r["losses"]) == 2
            if r["mesh"] != [1, 1]:
                assert r["collectives_per_step"]["all-gather"]["count"] > 0
    assert launches["flash_attention"] == 2 * (4 + 8 + 8 + 16) \
        + (4 + 8 + 8 + 16) + 2 * (4 + 16) + (4 + 16)


def test_train_tp_layouts_rehearsed_on_the_cpu(cpu_chip_smoke, monkeypatch,
                                              capsys):
    """train_tp_layouts at reduced width, every coordinate on the CPU: each
    case's strategy as ``make_rules`` picks it, its float32 loss and
    gradients held to the one-device step's, the timed cases' flash
    launches a step held exactly (``layout_flash_launches``), every slice
    held more than once bit-equal after the steps, the collectives by
    kind, and the ulysses_sp decode over a cache split by KV heads held
    to one device, in one JSON line with the card beside the numbers."""
    import json

    import repro_torch.configs as configs
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda name: real(name).reduced())
    mod = cpu_chip_smoke
    small = {"hybrid_ulysses_sp": dict(seq=12, rep=dict(attn_window=5)),
             "moe_ulysses_sp": dict(seq=12),
             "encdec_ulysses_sp": dict(seq=10, rep=dict(enc_seq=24)),
             "dense_ulysses": dict(seq=8), "dense_heads_sp": dict(seq=8),
             "dense_zero2": dict(seq=8), "dense_zero2_master": dict(seq=8),
             "hybrid_heads": dict(seq=12, rep=dict(tp_strategy="heads",
                                                   attn_window=5)),
             "ssm_heads": dict(seq=8),
             "encdec_heads": dict(seq=10, rep=dict(tp_strategy="heads")),
             "gqa_heads": dict(seq=8, rep=dict(num_heads=40,
                                               num_kv_heads=8))}
    mod.TP_LAYOUTS = {n: {**c, "batch": 2, **small[n]}
                      for n, c in chip_smoke.TP_LAYOUTS.items()}
    mod.TP_LAYOUT_DECODE = dict(chip_smoke.TP_LAYOUT_DECODE, capacity=16,
                                position=10)
    _count_decode_on_cpu(monkeypatch)
    launches, shapes = mod.phase_train_tp_layouts(0)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    cases = {ln["case"]: ln for ln in lines if "case" in ln
             and "model" in ln}
    last = lines[-1]
    assert last["phase"] == "train_tp_layouts"
    assert last["card"] == "CPU rehearsal"
    assert list(cases) == list(chip_smoke.TP_LAYOUTS)
    want = {"hybrid_ulysses_sp": "ulysses_sp", "moe_ulysses_sp": "ulysses_sp",
            "encdec_ulysses_sp": "ulysses_sp", "dense_ulysses": "ulysses",
            "dense_heads_sp": "heads_sp", "dense_zero2": "heads",
            "dense_zero2_master": "heads", "hybrid_heads": "heads",
            "ssm_heads": "heads", "encdec_heads": "heads",
            "gqa_heads": "heads"}
    for name, c in cases.items():
        f32 = c["float32"]
        assert f32["tp_strategy"] == want[name]
        assert f32["loss_rel_err_vs_1x1"] <= last["f32_tol"]
        assert f32["worst_grad_rel_l2_vs_1x1"] <= last["f32_tol"]
        assert ("bfloat16" in c) == (name in ("hybrid_ulysses_sp",
                                              "moe_ulysses_sp",
                                              "encdec_ulysses_sp",
                                              "dense_zero2"))
    assert cases["gqa_heads"]["reduced"] == []
    timed = {n: c["bfloat16"] for n, c in cases.items() if "bfloat16" in c}
    # flash a step: 2 (remat) × rows × launches a sub-layer × sub-layers
    assert {n: [r["flash_launches_per_step"] for r in t.values()]
            for n, t in timed.items()} == {
        "hybrid_ulysses_sp": [2, 6], "moe_ulysses_sp": [4, 12],
        "encdec_ulysses_sp": [12, 36], "dense_zero2": [4, 8]}
    for t in timed.values():
        for mesh, r in t.items():
            assert len(r["losses"]) == chip_smoke.TP_LAYOUT_STEPS
            if mesh != "1x1":
                assert r["replicated_slices_bit_equal"] > 0
                assert r["step_vs_1x1"] > 0
    zero2 = timed["dense_zero2"]["2x1"]["collectives_per_step"]
    assert zero2["all-gather"]["count"] > 0
    assert zero2["all-reduce"]["count"] > 0
    assert launches["flash_attention"] == chip_smoke.TP_LAYOUT_STEPS * (
        2 + 6 + 4 + 12 + 12 + 36 + 4 + 8)
    assert launches["rglru_scan"] > 0
    dec = last["ulysses_sp_decode"]
    assert dec["tp_strategy"] == "ulysses_sp"
    assert dec["cache_k_spec"][3] == "model"
    assert dec["logits_rel_l2_vs_1x1"] <= last["f32_tol"]
    assert dec["decode_attention_launches"] == 4


def test_train_tp_layouts_rows_rehearsed_on_the_cpu(cpu_chip_smoke):
    """The kernels phase's rows at train_tp_layouts' shards (timers
    stubbed, tiny shapes): flash's windowed prefix form, its window
    reaching back across the prefix, and the encoder's non-causal shard,
    each within tolerance of its plain version in bf16 and f32, with a
    bound and SDPA's time."""
    mod = cpu_chip_smoke
    mod.time_ms = lambda fn, args, **k: (fn(*args), (0.0, True))[1]
    mod.call_ms = lambda fn, **k: (fn(), 0.0)[1]
    mod.LAYOUT_FLASH = {
        "hybrid": dict(chip_smoke.LAYOUT_FLASH["hybrid"], S=8, T=24, H=4,
                       d=16, window=12, prefix_pad=16, prefix_len=16),
        "encoder": dict(chip_smoke.LAYOUT_FLASH["encoder"], B=2, S=6, T=18,
                        H=4, KVH=4, d=16)}
    rows = mod.layout_flash_rows(torch.Generator().manual_seed(0))
    assert [(r["dtype"], r["causal"], r.get("window", 0)) for r in rows] == [
        ("bfloat16", True, 12), ("bfloat16", False, 0),
        ("float32", True, 12), ("float32", False, 0)]
    for r in rows:
        assert r["max_abs_err"] <= r["tol"] and r["bound_ms"] > 0
        assert r["library_ms"] == 0.0
    # the window keeps prefix rows 5..15 of the first query: 11 of 16
    assert rows[0]["kv_rows"] == 24 - 5


def test_backward_rows_rehearsed_on_the_cpu(cpu_chip_smoke):
    """The kernels phase's backward rows at tiny shapes (timers stubbed):
    each Function's gradients against autograd through the plain
    version, with a bound and the SDPA yardstick for flash."""
    mod = cpu_chip_smoke
    mod.time_ms = lambda fn, args, **k: (fn(*args), (0.0, True))[1]
    mod.call_ms = lambda fn, **k: (fn(), 0.0)[1]
    mod.BACKWARD_SHAPES = {
        "flash_attention": {
            "stablelm-3b": dict(B=2, S=32, H=4, KVH=4, d=80, window=0),
            "recurrentgemma-9b": dict(B=1, S=40, H=4, KVH=1, d=32,
                                      window=16)},
        "rglru_scan": dict(B=1, S=200, W=64),
        "ssd_chunk_scan": dict(B=2, S=32, H=4, P=8, N=16, chunk=16)}
    rows = mod.backward_kernel_rows(torch.Generator().manual_seed(0))
    assert [r["kernel"] for r in rows] == ["flash_attention_backward"] * 4 \
        + ["rglru_scan_backward", "ssd_chunk_scan_backward"]
    for r in rows:
        assert r["max_abs_err"] <= r["tol"] and r["bound_ms"] > 0
        assert r["forward_max_abs_err"] <= r["tol"]
        assert (r["library_ms"] is None) == (r["kernel"] !=
                                             "flash_attention_backward")
    # the SSD forward against a float64 step recurrence, both forms (on
    # the CPU both are the plain version)
    f64 = rows[-1]["forward_vs_float64"]
    assert f64.keys() == {"kernel", "plain"}
    assert all(v["y_rel_l2_err"] < 1e-5 and v["state_max_abs_err"] < 1e-4
               for v in f64.values())


def test_train_flash_rows_rehearsed_on_the_cpu(cpu_chip_smoke):
    """Flash's forward rows at the train shapes (tiny stand-ins, timers
    stubbed): within tolerance, NaN past the inputs' tails bit-equal, a
    bound, SDPA's time and the launches a train step."""
    mod = cpu_chip_smoke
    mod.time_ms = lambda fn, args, **k: (fn(*args), (0.0, True))[1]
    mod.call_ms = lambda fn, **k: (fn(), 0.0)[1]
    mod.TRAIN_FLASH = {
        "stablelm-3b": [("train", 2, 40, 40, 4, 4, 80, True, 64)],
        "whisper-medium": [("train cross", 2, 9, 33, 4, 4, 64, False, 48)]}
    rows = mod.train_flash_rows(torch.Generator().manual_seed(0))
    assert [(r["shape"], r["case"], r["causal"]) for r in rows] == [
        ("stablelm-3b", "train", True),
        ("whisper-medium", "train cross", False)]
    for r in rows:
        assert r["dtype"] == "bfloat16" and r["max_abs_err"] <= r["tol"]
        assert r["bound_ms"] > 0 and r["library_ms"] == 0.0
        assert r["launch_key"]["B"] == 2
    assert [r["launches_per_train_step"] for r in rows] == [64, 48]


def test_profiled_train_step_ranges():
    """A profiled train step names its forward, each Function's backward
    and the optimizer as profiler ranges (here on the
    CPU, which gives them no device time); each Function counts its
    backwards."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.training.optimizer import AdamW

    model = build_model(get_config("recurrentgemma-9b").reduced())
    opt = AdamW()
    state = steps.init_train_state(model, opt, 0, device="cpu")
    batch = {k: torch.randint(0, 100, (1, 8)) for k in ("tokens", "targets")}
    counters = launch_counters()
    chip_smoke.zero_launches(counters)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.make_train_step(model, opt)(state, batch)
    got = chip_smoke.range_device_ms(prof, chip_smoke.TRAIN_RANGE)
    assert {k: v["calls"] for k, v in got.items()} == {
        "train:forward": 1, "train:optimizer": 1,
        "train:backward:rglru_scan": 2, "train:backward:flash_attention": 1}
    assert {n: c.backwards for n, c in counters.items() if c.backwards} \
        == {"rglru_scan": 2, "flash_attention": 1}


def _count_paged_on_cpu(monkeypatch):
    """Each CPU call of paged decode's plain version counted as its
    launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops as pa
    ref = pa.paged_decode_attention_ref

    def counted(q, kp, vp, table, lengths, *, window=0):
        _build.count_launch(pa.paged_decode_attention,
                            pa.launch_key(q, kp, table, window=window))
        return ref(q, kp, vp, table, lengths, window=window)
    monkeypatch.setattr(pa, "paged_decode_attention_ref", counted)


def test_serve_tp_rehearsed_on_the_cpu(cpu_chip_smoke, monkeypatch, capsys):
    """The tensor-parallel phase on reduced stablelm-3b: tp = 1, 2, 4 over
    repeated CPU devices, exact launches per shard, each shard's pool at
    the estimate / tp, the float32 tokens equal across tp, and launch
    keys at 4/tp heads.  The CPU engine captures no graph."""
    import json

    import repro_torch.configs as configs
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda name: real(name).reduced())
    _count_paged_on_cpu(monkeypatch)
    mod = cpu_chip_smoke
    mod.call_ms = lambda fn, **k: (fn(), 0.0)[1]
    graphs = []

    def no_graph(label, graph, steps, per_step):
        assert graph is None and steps > 0
        graphs.append((label, per_step))
        return {"steps": steps}
    mod.check_graph = no_graph
    launches, shapes = mod.phase_serve_tp(0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_tp" and line["shards_on_one_card"]
    assert [r["tp"] for r in line["bfloat16"]] == [1, 2, 4]
    for r in line["bfloat16"]:
        assert len(r["shard_pool_bytes"]) == r["tp"]
        assert sum(r["shard_pool_bytes"]) == r["estimate_paged_bytes"]
        assert r["launches"]["paged_decode_attention"] == \
            2 * r["tp"] * r["decode_steps"]
        assert r["launches"]["flash_attention"] == \
            2 * r["tp"] * r["prefill_chunks"]
        heads = {k["H"] for k in r["launches_by_shape"][
            "paged_decode_attention"]}
        assert heads == {4 // r["tp"]}
    assert line["bfloat16"][0]["tokens_agreeing_with_tp1"] == \
        line["bfloat16"][0]["tokens"]
    assert all(r["tokens_equal_tp1"] for r in line["float32"]["by_tp"])
    assert [p["paged_decode_attention"] for _, p in graphs] == \
        [2, 4, 8, 4, 8, 16]
    assert launches["paged_decode_attention"] == sum(
        r["launches"]["paged_decode_attention"] for r in line["bfloat16"]
        + line["float32"]["by_tp"])


def test_ef_allreduce_rehearsed_on_the_cpu(cpu_chip_smoke, monkeypatch,
                                           capsys):
    """The compressed all-reduce phase on reduced stablelm-3b's two
    gradient trees, with the value budget cut so that leaves are left
    out: the error within one int8 step, the wire bytes those of
    ``wire_bytes``."""
    import json

    import repro_torch.configs as configs
    from repro_torch.training import compression as comp
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda name: real(name).reduced())
    mod = cpu_chip_smoke
    mod.EF_VALUE_BUDGET = 40_000
    assert mod.phase_ef_allreduce(0) == ({}, {})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "ef_allreduce" and line["shards"] == 2
    assert 0 < line["values"] <= 40_000 < line["values_of_tree"]
    assert line["left_out"] and line["leaves"] + len(line["left_out"]) \
        == line["leaves_of_tree"]
    assert 0 < line["max_abs_err_vs_exact_mean"] < \
        line["max_abs_exact_mean"]
    assert line["fp32_bytes"] == 4 * line["values"]
    assert line["wire_bytes"] >= comp.wire_bytes(line["values"])
    assert all(r > 0 for r in line["residual_norm_per_shard"])


def _count_decode_on_cpu(monkeypatch):
    """Each CPU call of the contiguous decode wrappers' plain versions
    (whole, partial and the combine) counted as its launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da

    def count(ref_name, wrapper, key):
        ref = getattr(da, ref_name)

        def counted(*a, **k):
            _build.count_launch(wrapper, key(*a))
            return ref(*a, **k)
        monkeypatch.setattr(da, ref_name, counted)

    count("decode_attention_ref", da.decode_attention,
          lambda q, k, *_: da.launch_key(q, k))
    count("decode_attention_int8_ref", da.decode_attention_int8,
          lambda q, k, *_: da.launch_key(q, k))
    count("decode_partial_ref", da.decode_attention_partial,
          lambda q, k, *_: da.launch_key(q, k))
    count("decode_partial_int8_ref", da.decode_attention_int8_partial,
          lambda q, k, *_: da.launch_key(q, k))
    count("decode_combine_ref", da.decode_combine,
          lambda acc, ml, dtype: da.combine_key(acc, dtype))


def test_serve_tp_families_rehearsed_on_the_cpu(cpu_chip_smoke, monkeypatch,
                                                capsys):
    """The tensor-parallel families phase on reduced configs (the hybrid
    at 5 layers with a 16-slot window, short prompts): tp = 1, 2, 4 of
    olmoe-1b-7b (paged), recurrentgemma-9b (dense, then int8 at tp = 1
    and 2) and mamba2-2.7b (contiguous), whisper-medium at tp = 1 and 2
    (model level), exact launches per shard (the sequence split's
    partials and combines included), each shard's cache at the estimate
    / tp, float32 tokens equal across tp.  The CPU engine captures no
    graph."""
    import dataclasses
    import json

    import repro_torch.configs as configs
    real = configs.get_config

    def reduced(name):
        cfg = real(name).reduced()
        if name == "recurrentgemma-9b":
            cfg = dataclasses.replace(cfg, num_layers=5, attn_window=16)
        return cfg
    monkeypatch.setattr(configs, "get_config", reduced)
    _count_paged_on_cpu(monkeypatch)
    _count_decode_on_cpu(monkeypatch)
    mod = cpu_chip_smoke
    mod.call_ms = lambda fn, **k: (fn(), 0.0)[1]
    mod.MAX_LEN = 64
    mod.HYBRID_PROMPTS = (40, 33, 20, 12, 9, 5, 3, 2)
    mod.HYBRID_INT8_PROMPTS = (40, 12, 3, 2)
    mod.SSM_PROMPTS = (40, 33, 20, 12, 9, 5, 3, 2)
    graphs = []

    def no_graph(label, graph, steps, per_step):
        assert graph is None and steps > 0
        graphs.append((label, per_step))
        return {"launches_per_replay": {n: k for n, k in per_step.items()
                                        if k}}
    mod.check_graph = no_graph
    launches, shapes = mod.phase_serve_tp_families(0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_tp_families"
    models = {m["model"] + "/" + m.get("kv_cache_dtype", "activation"): m
              for m in line["models"]}
    assert len(line["models"]) == 5
    for m in line["models"]:
        tps = [r["tp"] for r in m["bfloat16"]]
        assert tps in ([1, 2, 4], [1, 2])
        assert m["bfloat16"][0]["tokens_equal_tp1_share"] == 1.0
        assert all(r["tokens_equal_tp1"] for r in m["float32"]["by_tp"])
        for r in m["bfloat16"]:
            assert len(r["shard_cache_bytes"]) == r["tp"]
    hyb = models["recurrentgemma-9b/activation"]["bfloat16"]
    # 5 layers: (rglru, rglru, attn) + two rglru: 1 attention block
    for r in hyb:
        per = r["launches_per_step"]
        if r["tp"] == 1:
            assert per == {"decode_attention": 1}
        else:
            assert per == {"decode_attention_partial": r["tp"],
                           "decode_combine": 1}
        assert r["launches"]["rglru_scan"] == 4 * r["tp"] * r["admissions"]
    int8 = models["recurrentgemma-9b/int8"]["bfloat16"]
    assert int8[1]["launches_per_step"] == {
        "decode_attention_int8_partial": 2, "decode_combine": 1}
    ssm = models["mamba2-2.7b/activation"]
    assert ssm["reshard"]["copies_from_other_shards"] > 0
    for r in ssm["bfloat16"]:
        assert r["launches"] == {"ssd_chunk_scan": 2 * r["tp"]
                                 * r["admissions"]}
    moe = models["olmoe-1b-7b/activation"]["bfloat16"]
    for r in moe:
        assert r["launches_per_step"] == {"paged_decode_attention":
                                          2 * r["tp"]}
    enc = models["whisper-medium/activation"]
    assert enc["level"] == "model"
    assert [r["tp"] for r in enc["bfloat16"]] == [1, 2]
    assert launches["decode_combine"] > 0
    assert launches["decode_attention_partial"] > 0
    assert shapes["decode_combine"]


def test_serve_tp_fallbacks_rehearsed_on_the_cpu(cpu_chip_smoke,
                                                 monkeypatch, capsys):
    """The fallbacks phase on reduced configs that reach the full-width
    mixed layouts: recurrentgemma-9b at 5 layers, a 16-slot window and
    d_ff 192 (only the MLPs split over three shards; dense and int8 KV),
    mamba2-2.7b with ssm_state 14 (only the conv splits), whisper-medium
    over 24 frames (the cross memory split by sequence, the self cache
    whole) at tp = 1 and 3, and qwen3-14b's 40 q over 8 KV heads at
    tp = 1 and 5 on the paged engine (a launch a run).  Exact launches,
    each shard's cache at the rules' local shapes, the replicated leaves
    bit-equal across shards, float32 tokens equal across tp.  The CPU
    engine captures no graph."""
    import dataclasses
    import json

    import repro_torch.configs as configs
    real = configs.get_config
    changes = {"recurrentgemma-9b": dict(num_layers=5, attn_window=16,
                                         d_ff=192),
               "mamba2-2.7b": dict(ssm_state=14),
               "whisper-medium": dict(enc_seq=24),
               "qwen3-14b": dict(num_heads=40, num_kv_heads=8)}
    monkeypatch.setattr(configs, "get_config", lambda name: dataclasses.replace(
        real(name).reduced(), **changes.get(name, {})))
    _count_paged_on_cpu(monkeypatch)
    _count_decode_on_cpu(monkeypatch)
    mod = cpu_chip_smoke
    mod.call_ms = lambda fn, **k: (fn(), 0.0)[1]
    mod.MAX_LEN = 64
    mod.ENCDEC_CAPACITY = 32         # 4 prompt tokens and 16 steps
    mod.HYBRID_PROMPTS = (40, 33, 20, 12, 9, 5, 3, 2)
    mod.HYBRID_INT8_PROMPTS = (40, 12, 3, 2)
    mod.SSM_PROMPTS = (40, 33, 20, 12, 9, 5, 3, 2)
    mod.SERVE_ENGINE = dict(mod.SERVE_ENGINE, max_len=128, prefill_chunk=32)
    mod.SERVE_PREFIX = 32
    mod.SERVE_SUFFIXES = (3, 5, 9, 17)

    def no_graph(label, graph, steps, per_step):
        assert graph is None and steps > 0
        return {"launches_per_replay": {n: k for n, k in per_step.items()
                                        if k}}
    mod.check_graph = no_graph
    launches, shapes = mod.phase_serve_tp_fallbacks(0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_tp_fallbacks"
    models = {m["model"] + "/" + m.get("kv_cache_dtype", "activation"): m
              for m in line["models"]}
    assert len(line["models"]) == 5
    for m in line["models"]:
        assert [r["tp"] for r in m["bfloat16"]] in ([1, 3], [1, 5])
        assert all(r["tokens_equal_tp1"] for r in m["float32"]["by_tp"])
        assert m["bfloat16"][1]["replicated_leaves_bit_equal"] > 0
    for name in ("recurrentgemma-9b/activation", "recurrentgemma-9b/int8"):
        r = models[name]["bfloat16"][1]   # the whole ring, a launch a shard
        kname = "decode_attention_int8" if "int8" in name \
            else "decode_attention"
        assert r["launches_per_step"] == {kname: 3}
        assert r["launches"]["rglru_scan"] == 4 * 3 * r["admissions"]
    assert models["mamba2-2.7b/activation"]["reshard"][
        "copies_from_other_shards"] > 0
    enc = models["whisper-medium/activation"]["bfloat16"][1]
    assert enc["launches"]["decode_combine"] == 2 * mod.TP_FAMILY_NEW
    qwen = models["qwen3-14b/activation"]
    assert qwen["cut"] == "2 of 40 layers"
    # runs of 2, 3, 1, 3 and 2 a shard: 11 launches a layer
    assert qwen["bfloat16"][1]["launches_per_step"] == {
        "paged_decode_attention": 2 * 11}
    assert launches["decode_attention_partial"] > 0
    assert shapes["paged_decode_attention"]


def test_fallback_kernel_rows_rehearsed_on_the_cpu(cpu_chip_smoke, capsys):
    """The kernels phase's rows at the fallbacks' new shapes (timers
    stubbed): the paged decode kernel at each run of qwen3-14b's q heads
    at tp = 5, read in place from the pool of 8 KV heads, and the partial
    over a third of whisper-medium's 1500 frames with the combine of
    three, each within tolerance of its plain version, with a bound and a
    library call where there is one; the decode wrappers on a cache
    narrowed to a run of heads within tolerance of their plain versions.
    The launches a layer of qwen3-14b at tp = 5, counted from the GQA
    mapping alone, are the 11 runs."""
    mod = cpu_chip_smoke
    assert mod.attention_runs(types.SimpleNamespace(
        num_heads=40, num_kv_heads=8), 5) == 11
    assert mod.attention_runs(types.SimpleNamespace(
        num_heads=32, num_kv_heads=8), 4) == 4
    mod.time_ms = lambda fn, args, **k: (fn(*args), (0.0, True))[1]
    mod.call_ms = lambda fn, **k: (fn(), 0.0)[1]
    gen = torch.Generator().manual_seed(0)
    rows = [r for r in mod.fallback_kernel_rows(gen)
            if r["dtype"] == "float32"]
    assert [(r["kernel"], r.get("H"), r.get("KVH")) for r in rows] == [
        ("paged_decode_attention", 5, 1), ("paged_decode_attention", 3, 1),
        ("paged_decode_attention", 2, 1), ("paged_decode_attention", 1, 1),
        ("paged_decode_attention", 8, 2),
        ("decode_attention_partial", 16, 16), ("decode_combine", 16, None)]
    for r in rows:
        assert r["max_abs_err"] <= r["tol"] and r["bound_ms"] > 0
    assert rows[5]["C"] == 500 and rows[5]["of_slots"] == 1500
    assert rows[6]["shards"] == 3
    assert all(r["library_ms"] == 0.0 for r in rows[:6])
    views = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if "decode_head_views" in ln]
    assert [v["decode_head_views"] for v in views] == ["bfloat16",
                                                       "float32"]
    for v in views:
        assert set(v["max_abs_err"]) == {"decode_attention",
                                         "decode_attention_int8",
                                         "decode_attention_partial"}
        assert max(v["max_abs_err"].values()) <= v["tol"]


def test_decode_split_rows_rehearsed_on_the_cpu(cpu_chip_smoke):
    """The partial and combine rows at recurrentgemma-9b's shard shapes
    (timers stubbed): each within tolerance of its plain version, the
    merged output within tolerance of the unsplit decode, a bound, and
    SDPA as the partial rows' library call."""
    mod = cpu_chip_smoke
    mod.time_ms = lambda fn, args, **k: (fn(*args), (0.0, True))[1]
    mod.call_ms = lambda fn, **k: (fn(), 0.0)[1]
    gen = torch.Generator().manual_seed(0)
    rows = []
    for kname in ("decode_attention_partial",
                  "decode_attention_int8_partial"):
        rows += mod.decode_split_rows(gen, kname, 4, "float32",
                                      torch.float32)
    assert [r["kernel"] for r in rows] == [
        "decode_attention_partial", "decode_combine",
        "decode_attention_int8_partial"]
    for r in rows:
        assert r["max_abs_err"] <= r["tol"] and r["bound_ms"] > 0
        assert r["shape"] == "recurrentgemma-9b/tp4"
    assert rows[0]["C"] == 512 and rows[0]["library_ms"] == 0.0
    assert rows[1]["n_split"] == 4 and rows[1]["library_ms"] is None
    assert rows[1]["merged_vs_unsplit_decode_err"] <= 2e-5
    assert set(mod.SUMMARY_CASE) >= {"decode_attention_partial",
                                     "decode_attention_int8_partial",
                                     "decode_combine"}
    assert all(n in mod.SOURCES and n in mod.REPLACES
               for n in mod.SUMMARY_CASE)


def test_poppy_apps_rehearsed_on_the_cpu(cpu_chip_smoke, monkeypatch,
                                         capsys):
    """The compound-AI programs on a tiny stablelm through the port's own
    PopPy core, dispatcher and paged engine: standard Python against
    PopPy for programs A and B (results, report lines, memories, tokens
    and ≡_A traces held inside the phase), occupancy 1 against the
    fan-out, program C (blocking clients on threads, one external in a
    worker process) equal to A, the batched run's shared-prefix counts,
    and exact launches (each CPU call of paged decode's plain version
    counted as its launch).  The CPU engine captures no decode graph, so
    the graph check is recorded."""
    import json

    import repro_torch.configs as configs
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda name: real(name).reduced())
    _count_paged_on_cpu(monkeypatch)
    mod = cpu_chip_smoke
    graphs = []

    def no_graph(label, graph, steps, per_step):
        assert graph is None and steps > 0
        graphs.append(label)
        return {"steps": steps}
    mod.check_graph = no_graph
    launches, shapes = mod.phase_poppy_apps(0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "poppy_apps" and line["layers"] == 2
    for prog, fan_out in (("A", 8), ("B", 5)):
        assert line[prog]["standard"]["max_occupancy"] == 1
        assert line[prog]["poppy"]["max_occupancy"] == fan_out
        assert line[prog]["poppy"]["decode_steps"] \
            < line[prog]["standard"]["decode_steps"]
    assert line["C"]["process_checksum"] >= 0
    assert line["A_batched_prefix_cache"]["prefix_batches"]["batches"] >= 1
    runs = [line["A"]["standard"], line["A"]["poppy"], line["B"]["standard"],
            line["B"]["poppy"], line["C"]["poppy"],
            line["A_batched_prefix_cache"]]
    assert launches == {
        "paged_decode_attention": sum(2 * r["decode_steps"] for r in runs),
        "flash_attention": sum(2 * r["prefill_chunks"] for r in runs)}
    assert sum(shapes["paged_decode_attention"].values()) == \
        launches["paged_decode_attention"]
    assert len(graphs) == len(runs) + 1
