"""The port's input shapes (``repro_torch.configs.shapes``), serving KV
estimates (``repro_torch.launch.dryrun``) and train-state layout
(``repro_torch.launch.steps``) against the reference's, for every config
in ``ARCH_IDS`` at full width (``meta`` tensors: nothing allocated), and
the estimates against what the port's engine allocates."""

import jax
import numpy as np
import pytest
import torch

import repro.launch.steps as steps_ref
import repro.sharding.rules as RJ
import repro_torch.launch.steps as steps_port
import repro_torch.sharding.rules as RT
from repro.configs import ARCH_IDS
from repro.configs import SHAPES as SHAPES_J
from repro.configs import get_config as get_config_jax
from repro.configs import input_specs as input_specs_jax
from repro.configs import shape_applicable as applicable_jax
from repro.launch import dryrun as dryrun_ref
from repro.models import build_model as build_jax
from repro.training.optimizer import AdamW as AdamWJ
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.configs import shape_applicable
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.prefix_cache import tree_nbytes
from repro_torch.training.optimizer import AdamW

MESHES = [((1, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model"))]


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _sig(leaf):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    return tuple(leaf.shape), str(leaf.dtype).split(".")[-1]


def test_shape_table_matches_reference():
    assert list(SHAPES) == list(SHAPES_J)
    for name, s in SHAPES.items():
        j = SHAPES_J[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_applicability_match_reference(arch):
    cj, ct = get_config_jax(arch), get_config(arch)
    for name in SHAPES:
        assert shape_applicable(ct, SHAPES[name]) == \
            applicable_jax(cj, SHAPES_J[name])
        got = input_specs(ct, SHAPES[name])
        want = input_specs_jax(cj, SHAPES_J[name])
        assert list(got) == list(want)
        assert {k: _sig(v) for k, v in got.items()} == \
            {k: _sig(v) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kv_estimates_match_reference(arch):
    cj, ct = get_config_jax(arch), get_config(arch)
    for slots, length, ps in ((128, 32768, 16), (4, 64, 16), (8, 1024, 32)):
        want = dryrun_ref.serving_kv_estimate(cj, max_slots=slots,
                                              max_len=length, page_size=ps)
        got = dryrun.serving_kv_estimate(ct, max_slots=slots,
                                         max_len=length, page_size=ps)
        assert got.keys() == want.keys()
        assert {k: v for k, v in got.items() if k != "paged_unsupported"} \
            == {k: v for k, v in want.items() if k != "paged_unsupported"}
    if "paged_bytes" in want:
        assert dryrun.paged_kv_pool_bytes(ct, num_pages=64, page_size=16) \
            == dryrun_ref.paged_kv_pool_bytes(cj, num_pages=64,
                                              page_size=16)


@pytest.mark.parametrize("arch", ["stablelm-3b", "pixtral-12b",
                                  "olmoe-1b-7b", "recurrentgemma-9b",
                                  "mamba2-2.7b"])
def test_kv_estimate_matches_engine_allocation(arch):
    """As the reference's ``test_dryrun_kv_estimate_matches_engine_
    allocation``: the estimate is what the port's engine allocates."""
    cfg = get_config(arch).reduced()
    est = dryrun.serving_kv_estimate(cfg, max_slots=4, max_len=64,
                                     page_size=16)
    model = build_model(cfg)
    params = model.init(1, device="cpu")
    if est["layout"] == "paged":
        assert est["num_pages"] == 4 * 64 // 16
        paged = ServingEngine(model, params, max_slots=4, max_len=64,
                              page_size=16, device="cpu")
        assert paged.paged_kv and paged.num_pages == est["num_pages"]
        assert tree_nbytes(paged.kv_pages) == est["paged_bytes"]
        contig = ServingEngine(model, params, max_slots=4, max_len=64,
                               kv_layout="contiguous", device="cpu")
    else:
        assert "paged_unsupported" in est
        contig = ServingEngine(model, params, max_slots=4, max_len=64,
                               device="cpu")
    assert tree_nbytes(contig.cache) == est["contiguous_bytes"] > 0


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])) if isinstance(m, tuple) else str(m))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pick_microbatches_matches_reference(arch, mesh):
    cj, ct = get_config_jax(arch), get_config(arch)
    fm = FakeMesh(*mesh)
    for name in SHAPES:
        for target in (None, 2**28):
            assert steps_port.pick_microbatches(
                ct, SHAPES[name], fm, target_bytes=target) == \
                steps_ref.pick_microbatches(cj, SHAPES_J[name], fm,
                                            target_bytes=target)


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-moe-30b-a3b",
                                  "whisper-medium", "mamba2-2.7b"])
def test_abstract_train_state_and_specs_match_reference(arch, master):
    mj, mt = build_jax(get_config_jax(arch)), build_model(get_config(arch))
    oj, ot = AdamWJ(master_weights=master), AdamW(master_weights=master)
    want = _flat(steps_ref.abstract_train_state(mj, oj))
    got = _flat(steps_port.abstract_train_state(mt, ot))
    assert got.keys() == want.keys()
    assert {k: _sig(v) for k, v in got.items()} == \
        {k: _sig(v) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())
    fm = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    sj = steps_ref.train_state_pspecs(RJ.make_rules(fm, mj.cfg), mj, oj)
    st = steps_port.train_state_pspecs(RT.make_rules(fm, mt.cfg), mt, ot)
    flat_j = _flat(jax.tree.map(tuple, sj, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec)))
    assert _flat(st) == flat_j
    assert torch.float32 in {v.dtype for v in got.values()}
