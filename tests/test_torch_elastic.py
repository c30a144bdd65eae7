"""Elastic restore (the port's ``tests/test_elastic_multipod.py``): a
train state laid out on a 4×2 ("data", "model") mesh is checkpointed and
restored onto a 2×2×4 ("pod", "data", "model") mesh by the layout
``train_state_pspecs`` gives there; every leaf comes back bit-equal, split
over the new mesh."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import init_train_state, train_state_pspecs
from repro_torch.models import build_model
from repro_torch.sharding import rules as R
from repro_torch.sharding.placement import ShardedTensor, named, place_tree
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamW
from repro_torch.training.tree import flatten


def _mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.array(["cpu"] * n, dtype=object).reshape(shape), axes)


@pytest.mark.parametrize("master", [False, True])
def test_elastic_restore_across_mesh_shapes(tmp_path, master):
    cfg = get_config("stablelm-3b").reduced().replace(
        d_model=64, num_heads=4, num_kv_heads=4)
    model = build_model(cfg)
    opt = AdamW(master_weights=master)
    state = init_train_state(model, opt, 0, device="cpu")

    # "pod A": 4×2
    mesh_a = _mesh((4, 2), ("data", "model"))
    specs_a = train_state_pspecs(R.make_rules(mesh_a, cfg), model, opt)
    on_a = place_tree(state, named(mesh_a, specs_a))
    ckpt.save(tmp_path, 5, on_a)

    # "pod B": another shape (2×2×4, multi-pod style)
    mesh_b = _mesh((2, 2, 4), ("pod", "data", "model"))
    specs_b = train_state_pspecs(R.make_rules(mesh_b, cfg), model, opt)
    restored, step = ckpt.restore(tmp_path, state,
                                  shardings=named(mesh_b, specs_b))
    assert step == 5
    want, got = flatten(state), flatten(restored)
    assert got.keys() == want.keys()
    split = 0
    for k, a in want.items():
        b = got[k]
        assert isinstance(b, ShardedTensor)
        assert set(b.mesh.axis_names) == {"pod", "data", "model"}
        assert b.spec == tuple(flatten(specs_b)[k])
        full = b.full()
        assert full.dtype == a.dtype and torch.equal(full, a), k
        if any(e is not None for e in b.spec):
            split += 1
            assert b.local((0, 0, 0)).numel() < a.numel()
    assert split > 0
