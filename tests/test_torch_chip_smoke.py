"""The parts of ``chip_smoke.py`` that run without a card: the rotation of
timed inputs past the L2 cache, the build report's parse of the ptxas
output, the kernel names and the HMMA counts of the SASS, and the serve
phases' checks of the decode graph (its launch tally and the bit-equal
replay against an eager step)."""

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
