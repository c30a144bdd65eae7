"""The parts of ``chip_smoke.py`` that run without a card: the rotation of
timed inputs past the L2 cache, the build report's parse of the ptxas
output, the kernel names and the HMMA counts of the SASS, the serve
phases' checks of the decode graph (its launch tally and the bit-equal
replay against an eager step), whisper-medium's decode byte floor, the
summary line's rows, flash's NaN-tail check, and the trace and profile
reports."""

import collections
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
