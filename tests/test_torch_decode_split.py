"""The sequence-split contiguous decode: the decode kernel's partial
entries and the combine of partials stacked across shards.

On the CPU the wrappers run their plain versions: the per-chunk partials
(max scaled score, sum of exponentials, unnormalised accumulator) and
their merge.  A cache of C slots cut into tp slot ranges (as the serving
rules split recurrentgemma's one-KV-head ring) gives, partial by partial
and merged once, the unsplit plain decode within 1e-6 in f32, dense and
int8, on rows before and past the ring's wrap (pos >= C) and on a row
with no valid slot in some shard.  Then the model's sharded decode
(``lm.tp_decode_attention``) against the one-device ``decode_attention``
over several steps: outputs within 1e-6 and the shards' slot ranges,
put back together, equal to the one-device cache (each step's K/V
written only on the shard that owns its slot)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import build_model, lm  # noqa: E402
from repro_torch.sharding.placement import ShardedParams  # noqa: E402
from repro_torch.sharding.rules import (  # noqa: E402
    make_serving_rules,
    params_pspecs,
)

TOL = 1e-6
B, H, KVH, D, C = 4, 16, 1, 32, 16


def _inputs(seed, int8):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, 1, H, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, C, KVH, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, C, KVH, D).astype(np.float32))
    # rows before the wrap (pos 3, 9), past it (pos 16, 37)
    positions = torch.tensor([3, 9, 16, 37], dtype=torch.int32)
    valid = att.decode_valid(positions, C, window=C)
    if not int8:
        return q, (k, v), valid
    qk, sk = att.quantize_kv(k)
    qv, sv = att.quantize_kv(v)
    return q, (qk, qv, sk, sv), valid


def _slots(t, r, n):
    w = C // n
    return t[:, r * w:(r + 1) * w].contiguous()


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_partials_of_split_cache_merge_to_unsplit_decode(tp, int8):
    q, kv, valid = _inputs(tp, int8)
    if int8:
        want = ref.decode_attention_int8_ref(q, *kv, valid)
    else:
        want = ref.decode_attention_ref(q, *kv, valid)
    parts = []
    for r in range(tp):
        sl = [_slots(t, r, tp) for t in kv]
        vr = _slots(valid, r, tp)
        parts.append(ops.decode_attention_int8_partial(q, *sl, vr) if int8
                     else ops.decode_attention_partial(q, *sl, vr))
    for acc, ml in parts:
        assert acc.shape == (B, H, 1, D) and ml.shape == (B, H, 1, 2)
    acc = torch.cat([a for a, _ in parts], 2)
    ml = torch.cat([m for _, m in parts], 2)
    got = ops.decode_combine(acc, ml, torch.float32)
    assert (got - want).abs().max().item() <= TOL
    # row 0 (pos 3) has no valid slot past shard 0's range
    assert ml[0, :, -1, 1].eq(0).all() and ml[0, :, -1, 0].eq(-1e30).all()


@pytest.mark.parametrize("chunk", [1, 3, 8, C])
def test_partial_chunks_do_not_change_the_merge(chunk):
    """The plain partial at the kernel's chunk plans (any chunk): the
    merge of its chunks is the unsplit decode."""
    q, (k, v), valid = _inputs(0, False)
    acc, ml = ref.decode_partial_ref(q, k, v, valid, chunk)
    assert acc.shape[2] == -(-C // chunk)
    got = ref.decode_combine_ref(acc, ml, torch.float32)
    want = ref.decode_attention_ref(q, k, v, valid)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_ring_decode_matches_one_device(tp, kv_dtype):
    """recurrentgemma's attention block (one KV head, an 8-slot ring) over
    12 steps from position 3: every step's output within 1e-6 of the
    one-device decode, the shards' caches equal to its cache."""
    cfg = get_config("recurrentgemma-9b").reduced().replace(
        num_layers=3, attn_window=8, kv_cache_dtype=kv_dtype)
    model = build_model(cfg)
    params = model.init(2, device="cpu")
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    sp = ShardedParams(params, params_pspecs(make_serving_rules(mesh, cfg),
                                             model), mesh)
    tpl = lm.TensorParallel(cfg, sp)
    assert not tpl.kv_split and tpl.attn_sum
    kind, p = lm.blocks(cfg, params)[2]
    ps = [lm.blocks(cfg, s)[2][1] for s in sp.shards]
    assert kind == "attn_mlp_local"
    one = att.init_kv_cache(cfg, 2, 8, torch.float32, "cpu")
    shards = lm.init_cache_tp(cfg, sp, 2, 32)
    caches = [lm.blocks(cfg, shards[lm.shard_key(r)])[2][1]
              for r in range(tp)]
    assert caches[0]["k"].shape[1] == 8 // tp
    rng = np.random.RandomState(1)
    pos = torch.tensor([3, 6], dtype=torch.int32)
    for _ in range(12):
        x = torch.from_numpy(rng.randn(2, 1, cfg.d_model).astype(np.float32))
        xn = lm.apply_norm(cfg, p["ln1"], x)
        want = att.decode_attention(cfg, p["attn"], xn, one, pos, window=8)
        got = lm.tp_decode_attention(cfg, tpl, ps, xn, caches, pos,
                                     window=8, capacity=32)
        assert (got - want).abs().max().item() <= TOL
        pos = pos + 1
    for name, leaf in one.items():
        joined = torch.cat([c[name] for c in caches], dim=1)
        torch.testing.assert_close(joined, leaf, atol=0, rtol=0)
