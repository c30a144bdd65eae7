"""Gradients through the port's kernel wrappers against the JAX package.

Each wrapper that trains (flash attention, the RG-LRU scan, the SSD chunk
scan) is a ``torch.autograd.Function``.  On the CPU its forward is the
plain version; its backward is the one the card runs too: flash and SSD
recompute through the plain version (the reference's ``_bwd``), RG-LRU
runs the scan again on reversed inputs.  The same numpy inputs and
cotangents go through ``jax.vjp`` of the reference's own custom-VJP op
with its Pallas kernel in interpret mode.  Tolerance: relative L2 error
of 1e-5 per gradient, float32 (the two sides sum in other orders; the
readings are ~1e-7).  Each Function also passes
``torch.autograd.gradcheck`` in float64 at a tiny shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.flash_attention import ops as fa_jax  # noqa: E402
from repro.kernels.rglru import ops as lru_jax  # noqa: E402
from repro.kernels.ssd import ops as ssd_jax  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_pt  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_pt  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_pt  # noqa: E402

GRAD_TOL = 1e-5


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def vjp_both(jax_fn, torch_fn, inputs, cotangent):
    """(outputs, grads) of the same numpy ``inputs`` and ``cotangent`` (an
    array or a tuple of them) through ``jax.vjp(jax_fn)`` and through
    autograd of ``torch_fn``."""
    out_j, vjp = jax.vjp(jax_fn, *map(jnp.asarray, inputs))
    cot_j = jax.tree.map(jnp.asarray, cotangent)
    grads_j = vjp(cot_j)
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out_t = torch_fn(*ts)
    cot_t = tuple(map(torch.tensor, cotangent)) \
        if isinstance(cotangent, tuple) else torch.tensor(cotangent)
    grads_t = torch.autograd.grad(out_t, ts, cot_t)
    return (out_j, out_t), (grads_j, grads_t)


def assert_grads(grads, names):
    grads_j, grads_t = grads
    for name, gj, gt in zip(names, grads_j, grads_t):
        assert rel_l2(gt.numpy(), gj) <= GRAD_TOL, name


# ---------------------------------------------------------------------------
# flash attention


@pytest.mark.parametrize("B,S,H,KVH,d,causal,window", [
    (2, 64, 4, 4, 16, True, 0),       # causal
    (1, 70, 4, 4, 16, True, 16),      # windowed, ragged tile
    (2, 40, 4, 4, 16, False, 0),      # non-causal (whisper's encoder)
    (2, 48, 8, 2, 16, True, 0),       # GQA
    (1, 40, 2, 1, 80, True, 0),       # d = 80 (stablelm-3b's head)
])
def test_flash_grads_match_jax_custom_vjp(B, S, H, KVH, d, causal, window):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    g = rng.standard_normal((B, S, H, d)).astype(np.float32)
    (out_j, out_t), grads = vjp_both(
        lambda q, k, v: fa_jax.flash_attention(q, k, v, causal, window,
                                               True),
        lambda q, k, v: fa_pt.flash_attention(q, k, v, causal=causal,
                                              window=window),
        (q, k, v), g)
    assert rel_l2(out_t.detach().numpy(), out_j) <= GRAD_TOL
    assert_grads(grads, ("dq", "dk", "dv"))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3),
                                           (False, 0)])
def test_flash_gradcheck_float64(causal, window):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 6, 2, 4, generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa_pt.flash_attention(q, k, v, causal=causal,
                                              window=window), (q, k, v))


def test_flash_prefix_mode_takes_no_gradient():
    """The prefix mode, once inference only, now takes a gradient (a
    ``ulysses_sp`` shard trains through it): asked for one, it gives
    autograd's through the plain version under the same mask; without
    one it runs as before."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(1, 4, 2, 8, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    kv = torch.randn(1, 12, 2, 8, generator=gen, dtype=torch.float64,
                     requires_grad=True)
    kw = dict(prefix_pad=8, prefix_len=5)
    got = torch.autograd.grad(fa_pt.flash_attention(q, kv, kv, **kw).sum(),
                              (q, kv))
    want = torch.autograd.grad(
        fa_ref.flash_attention_ref(q, kv, kv, **kw).sum(), (q, kv))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    with torch.no_grad():
        fa_pt.flash_attention(q, kv, kv, **kw)


# ---------------------------------------------------------------------------
# RG-LRU scan


@pytest.mark.parametrize("S", [1, 37, 300])
def test_rglru_grads_match_jax_custom_vjp(S):
    """The reversed-scan backward against the reference's VJP through its
    associative scan; S = 300 crosses the kernel's 128-step tiles."""
    rng = np.random.default_rng(S)
    a = (1 / (1 + np.exp(-rng.standard_normal((1, S, 16))))).astype(
        np.float32)
    b = rng.standard_normal((1, S, 16)).astype(np.float32)
    g = rng.standard_normal((1, S, 16)).astype(np.float32)
    (out_j, out_t), grads = vjp_both(
        lambda a, b: lru_jax.rglru_scan(a, b, True), lru_pt.rglru_scan,
        (a, b), g)
    assert rel_l2(out_t.detach().numpy(), out_j) <= GRAD_TOL
    assert_grads(grads, ("da", "db"))


def test_rglru_backward_is_the_reversed_scan(monkeypatch):
    """The backward runs the forward scan once, on reversed inputs: the
    kernel on the card (counted there), the plain version here."""
    calls = []
    real = lru_pt._forward
    monkeypatch.setattr(lru_pt, "_forward",
                        lambda *a: calls.append(a) or real(*a))
    a = torch.rand(1, 5, 4, requires_grad=True)
    b = torch.randn(1, 5, 4, requires_grad=True)
    h = lru_pt.rglru_scan(a, b)
    assert len(calls) == 1
    h.sum().backward()
    assert len(calls) == 2
    ar, gr = calls[1][:2]
    assert torch.equal(ar[:, 0], torch.zeros(1, 4))
    assert torch.equal(ar[:, 1:], a.detach().flip(1)[:, :-1])
    assert torch.equal(gr, torch.ones(1, 5, 4))


def test_rglru_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(2, 7, 3, generator=gen, dtype=torch.float64,
                   requires_grad=True)
    b = torch.randn(2, 7, 3, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lru_pt.rglru_scan, (a, b))


def test_rglru_with_h0_takes_no_gradient():
    a = torch.rand(1, 4, 8, requires_grad=True)
    with pytest.raises(ValueError, match="only without h0"):
        lru_pt.rglru_scan(a, torch.zeros(1, 4, 8), torch.zeros(1, 8))


# ---------------------------------------------------------------------------
# SSD chunk scan


def _ssd_inputs(rng, b, S, H, P, N):
    xh = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(H)).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32)
    C = rng.standard_normal((b, S, N)).astype(np.float32)
    return xh, dt, a_log, B, C


@pytest.mark.parametrize("S,chunk", [(32, 8), (37, 8)])
def test_ssd_grads_match_jax_custom_vjp(S, chunk):
    """Chunked (S a multiple of the chunk) and a ragged tail, with
    cotangents on both the output and the final state."""
    rng = np.random.default_rng(S)
    b, H, P, N = 1, 2, 8, 16
    inputs = _ssd_inputs(rng, b, S, H, P, N)
    gy = rng.standard_normal((b, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((b, H, P, N)).astype(np.float32)
    (out_j, out_t), grads = vjp_both(
        lambda *xs: ssd_jax.ssd_chunked(*xs, chunk=chunk, interpret=True),
        lambda *xs: ssd_pt.ssd_chunked(*xs, chunk=chunk), inputs, (gy, gh))
    for oj, ot in zip(out_j, out_t):
        assert rel_l2(ot.detach().numpy(), oj) <= GRAD_TOL
    assert_grads(grads, ("dxh", "ddt", "da_log", "dB", "dC"))


def test_ssd_gradcheck_float64():
    rng = np.random.default_rng(0)
    xs = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
          for x in _ssd_inputs(rng, 1, 6, 2, 2, 3)]
    assert torch.autograd.gradcheck(
        lambda *xs: ssd_pt.ssd_chunked(*xs, chunk=4), xs)


def test_ssd_with_initial_state_takes_no_gradient():
    """The stateful (serving) path raises when asked for a gradient and
    runs without one."""
    rng = np.random.default_rng(0)
    xs = [torch.tensor(x, requires_grad=True)
          for x in _ssd_inputs(rng, 1, 8, 2, 4, 4)]
    h0 = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="only without an initial_state"):
        ssd_pt.ssd_chunked(*xs, chunk=4, initial_state=h0)
    with torch.no_grad():
        ssd_pt.ssd_chunked(*xs, chunk=4, initial_state=h0)
