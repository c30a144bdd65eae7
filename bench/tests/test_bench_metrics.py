"""Each metric's arithmetic on a synthetic run, and every reader's
silence where it finds nothing to read."""

import json
import pathlib

import pytest

from bench import flops
from bench.harness import Obs, Program, reader
from bench.profile import Timeline, short, union

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
RUN = json.loads((ROOT / "bench/configs/stablelm-3b.json").read_text())["run"]


def program(pid, start, end, calls, externals=()):
    p = Program(pid, "mapreduce", (), start, end, ok=True)
    p.llm = list(calls)
    p.externals = list(calls) + list(externals)
    return p


def synthetic():
    # window [10, 20]; the traced run's host window [10, 16]
    progs = [
        program(1, 8.0, 12.0, [(8.0, 9.0), (9.0, 12.0)]),       # 1 of 2
        program(2, 11.0, 15.0, [(11.0, 13.0), (11.0, 15.0)]),   # 2 of 2
        program(3, 14.0, 22.0, [(14.0, 18.0), (18.0, 22.0)]),   # 1 of 2
    ]
    ob = Obs(run=RUN, window=(10.0, 20.0),
             host_window=(10.0, 16.0), setup_s=33.0, programs=progs)
    ob.engine = {"occupancy": [2, 4, 6], "decode_step_s": [0.01, 0.02,
                                                            0.03],
                 "prefill_tokens_reused": 300,
                 "prefill_tokens_computed": 100}
    ob.chunks = [[11.0, 256, 0, 0.02], [12.0, 256, 256, 0.04],
                 [17.0, 128, 512, 0.5]]
    ob.steps = [(12.0, [100, 200]), (17.0, [300])]
    ops = [("flash_mma_kernel<80>(x)", 0.0, 0.5),
           ("paged_mma_kernel<80>(x)", 1.0, 1.1),
           ("decode_combine_kernel(x)", 1.1, 1.2),
           ("gemm", 2.0, 3.0), ("gemm", 2.5, 3.5)]
    ob.timeline = Timeline(
        ops, {"bench.decode_step": [(0.9, 1.3)],
              "bench.prefill_chunk": [(-0.1, 0.8), (1.9, 3.6)]},
        {"bench.prefill_chunk": [(0.0, 0.5), (2.0, 3.5)],
         "bench.moe": [(2.4, 3.6)]}, window_s=4.0)
    return ob


def value(name, ob):
    return reader(name)(ob)


def test_end_to_end_arithmetic():
    ob = synthetic()
    # resolved in the window: program 1's second call (1 of 2), both of
    # program 2's, program 3's first (1 of 2)
    assert value("programs_per_s", ob) == pytest.approx(2.0 / 10.0)
    assert value("program_p50_s", ob) == pytest.approx(4.0)  # 1 and 2
    # calls dispatched in the window: 3, 2, 4, 4, 4 seconds long
    assert value("call_p95_s", ob) == pytest.approx(4.0)
    assert value("setup_s", ob) == 33.0


def test_runtime_and_engine_arithmetic():
    ob = synthetic()
    # programs done in [10, 16]: 1 (4 s of calls over 4 s) and 2 (6 / 4)
    assert value("runtime_parallelism", ob) == pytest.approx(1.25)
    ob.programs[0].externals.append((7.0, 8.0))
    # program 1: no external in [8, 9) ... all covered: 0; program 2:
    # [11, 15] covered: 0
    assert value("runtime_outside_calls_share", ob) == pytest.approx(0.0)
    ob.programs[1].externals = [(11.0, 12.0)]
    assert value("runtime_outside_calls_share", ob) == pytest.approx(
        (0.0 + 3.0 / 4.0) / 2)
    assert value("decode_occupancy", ob) == pytest.approx(4.0)
    assert value("prefix_reuse_share", ob) == pytest.approx(0.75)
    assert value("decode_step_ms", ob) == pytest.approx(20.0)
    assert value("prefill_chunk_ms", ob) == pytest.approx(30.0)


def test_device_arithmetic():
    ob = synthetic()
    tl = ob.timeline
    assert tl.busy_s == pytest.approx(0.5 + 0.2 + 1.5)
    assert value("device_idle_share", ob) == pytest.approx(1 - 2.2 / 4.0)
    # kernels inside the MoE spans: the two gemms' midpoints 2.5, 3.0
    # inside [2.4, 3.6]; inside the chunks: flash and the two gemms
    assert value("moe_prefill_share", ob) == pytest.approx(2.0 / 2.5)
    # profiled tail [16, 20]: step at 17 over 300 keys, chunk at 17
    paged = flops.paged_decode_bound_s(RUN, [300])
    assert value("paged_attn_roofline", ob) == pytest.approx(
        100 * paged / 0.2)
    flash = flops.flash_prefill_bound_s(RUN, 128, 512)
    assert value("flash_roofline", ob) == pytest.approx(100 * flash / 0.5)
    work = flops.prefill_chunk_flops(RUN, 256, 0) \
        + flops.prefill_chunk_flops(RUN, 256, 256) \
        + flops.decode_step_flops(RUN, [100, 200])
    assert value("step_mfu", ob) == pytest.approx(
        100 * work / (6.0 * flops.PEAK_BF16_FLOPS))
    gaps = dict(tl.idle_gaps())
    # gaps: [0.5, 1.0] mid 0.75 in a chunk's host range; [1.2, 2.0] mid
    # 1.6 in none
    assert gaps == pytest.approx({"prefill_chunk": 0.5, "runtime": 0.8})
    assert [n for n, _ in tl.device_ops(2)] == ["gemm", "flash_mma_kernel<80>"]


@pytest.mark.parametrize("name", [n for n in NAMES if n != "setup_s"])
def test_readers_are_silent_on_nothing(name):
    ob = Obs(run=RUN, window=(0.0, 10.0),
             host_window=(0.0, 6.0), setup_s=1.0, programs=[])
    got = value(name, ob)
    assert got is None or (name == "programs_per_s" and got == 0.0)


def test_work_counts():
    # one 2048-token chunk after 32 cached positions: causal pairs
    assert flops.chunk_pairs(2048, 32) == 2048 * 32 + 2048 * 2049 // 2
    # stablelm-3b's weights a token multiplies by: 32 layers of 4·2560²
    # attention and 3·2560·6912 MLP, and the head
    want = 32 * (4 * 2560 * 2560 + 3 * 2560 * 6912) + 2560 * 50304
    assert flops.matmul_params(RUN) == want
    # a bytes-bound decode attention: 32 layers of K and V over 1000 keys
    b = flops.paged_decode_bound_s(RUN, [1000])
    assert b == pytest.approx(32 * 2 * 80 * (2 * 32 * 1000 + 2 * 32)
                              / flops.HBM_BYTES_PER_S)


def test_union_and_short_names():
    assert union([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]
    assert short("void (anonymous namespace)::paged_mma_kernel<80>"
                 "(__nv_bfloat16 const*, int)") == \
        "(anonymous namespace)::paged_mma_kernel<80>"
    assert short("nvjet_tst_320x128") == "nvjet_tst_320x128"
