"""The port's loss and parameter gradients against the JAX package's, for
one reduced config of each family (dense, hybrid, SSM, MoE and the
encoder-decoder).

The parameters are the reference's init, converted with
``models/convert.py:from_jax``; the batch comes from the port's copy of
``LMDataset`` (plus seeded frames for whisper).  The reference runs
``jax.value_and_grad(Model.loss_fn)`` once with ``attention_impl=
"pallas_interpret"``, so that its kernels' custom VJPs run, and once with
``"xla"``.  Tolerances: the loss rtol 1e-5; each gradient leaf relative
L2 1e-4 (float32 on both sides; the readings are ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import device_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.training.data import LMDataset  # noqa: E402
from repro_torch.training.tree import flatten, unflatten  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("name", ["stablelm-3b", "recurrentgemma-9b",
                                  "mamba2-2.7b", "olmoe-1b-7b",
                                  "whisper-medium"])
def test_loss_and_grads_match_reference(name, impl):
    cfg_j = get_config_jax(name).reduced().replace(attention_impl=impl)
    cfg = get_config(name).reduced()
    mj, mt = build_jax(cfg_j), build_model(cfg)
    pj = mj.init(jax.random.PRNGKey(0))
    pt = from_jax(cfg, jax.tree.map(np.asarray, pj), device="cpu")
    batch = LMDataset(vocab_size=cfg.vocab_size, batch_size=2, seq_len=16,
                      seed=1).batch(0)
    if cfg.family == "enc_dec":
        batch["encoder_frames"] = np.random.default_rng(2).standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        mj.loss_fn, has_aux=True))(pj, jax.tree.map(jnp.asarray, batch))
    leaves = {k: v.requires_grad_() for k, v in flatten(pt).items()}
    loss_t, aux_t = mt.loss_fn(unflatten(pt, leaves),
                               device_batch(batch, "cpu"))
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    assert set(aux_t) == set(aux_j) == {"nll", "aux", "zloss"}
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    if cfg.family == "moe":
        assert float(aux_t["aux"].detach()) > 0
    flat_j = flatten(jax.tree.map(np.asarray, grads_j))
    assert flat_j.keys() == leaves.keys()
    for k, g in zip(leaves, grads_t):
        assert rel_l2(g.numpy(), flat_j[k]) <= GRAD_TOL, k
