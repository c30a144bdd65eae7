"""The plain reference of the benchmark's configurations: a float32
PyTorch forward of the dense and MoE decoders that the configuration
files' ``run`` blocks state, one sequence at a time, a layer at a time.

Equations (each as the port states them; ``assumed`` in the configuration
files lists where they depart from the published models):

- ``h = embed[tokens]``; per layer ``h += attn(norm1(h))``, then
  ``h += ffn(norm2(h))``; ``logits = norm_f(h) @ lm_head`` over the real
  vocabulary rows;
- layer norm ``(x - mean) / sqrt(var + eps) * scale + bias``; RMS norm
  ``x / sqrt(mean(x^2) + eps) * (1 + scale)``;
- attention: q, k, v projections, per-head RMS qk-norm where stated,
  rotary embedding over every dim of a head (NeoX halves, theta), causal
  softmax at ``head_dim ** -0.5``, output projection;
- SwiGLU MLP ``(silu(x W_gate) * (x W_up)) W_down``;
- MoE: float32 router softmax over the experts, the top k by a stable
  descending sort (ties to the lower index), gates renormalised to sum
  to 1, each token's output the gated sum of its k experts' SwiGLU
  (dropless: every assignment is computed).

``quant="fp8"`` is the control: every matrix product's two operands
rounded to float8 e4m3 with one scale a tensor (amax / 448) before an
float32 product.  Everything else, and the float32 reference, runs with
TF32 off.

Imports torch alone: nothing of the port.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import weights as wmod

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8(t):
    """``t`` rounded to float8 e4m3 under one scale, back in float32."""
    amax = t.abs().max().clamp(min=1e-12)
    s = amax / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Matmul:
    """The products of one forward: exact float32, or the fp8 control."""

    def __init__(self, quant=None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}: None or 'fp8'")
        self.q = fp8 if quant == "fp8" else (lambda t: t)

    def __call__(self, a, b):
        return self.q(a) @ self.q(b)


def norm(run, p, x):
    if run["norm_type"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + run["norm_eps"]) * p["scale"] \
            + p["bias"]
    return rms(x, p["scale"], run["norm_eps"])


def rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, positions, theta):
    """x [T, H, hd], rotated by NeoX halves over all hd dims."""
    half = x.shape[-1] // 2
    inv = theta ** -(torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = positions.to(torch.float64)[:, None] * inv
    c = torch.cos(ang).to(x.dtype)[:, None, :]
    s = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(run, mm, p, x):
    T, D = x.shape
    H, KVH, hd = run["num_heads"], run["num_kv_heads"], run["head_dim"]
    q = mm(x, p["wq"].reshape(D, H * hd)).view(T, H, hd)
    k = mm(x, p["wk"].reshape(D, KVH * hd)).view(T, KVH, hd)
    v = mm(x, p["wv"].reshape(D, KVH * hd)).view(T, KVH, hd)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if run["qk_norm"]:
        q = rms(q, p["q_norm"], run["norm_eps"])
        k = rms(k, p["k_norm"], run["norm_eps"])
    pos = torch.arange(T, device=x.device)
    q = rope(q, pos, run["rope_theta"])
    k = rope(k, pos, run["rope_theta"])
    G = H // KVH
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    out = torch.empty(T, H, hd, dtype=x.dtype, device=x.device)
    for h in range(H):                       # one head's scores at a time
        s = mm(q[:, h], k[:, h].T) * hd ** -0.5
        s = torch.where(keep, s, torch.full((), -math.inf, device=x.device))
        out[:, h] = mm(torch.softmax(s, dim=-1), v[:, h])
    return mm(out.reshape(T, H * hd), p["wo"].reshape(H * hd, D))


def swiglu(mm, x, w_gate, w_up, w_down):
    return mm(torch.nn.functional.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def moe(run, mm, p, x):
    E, K = run["num_experts"], run["num_experts_per_tok"]
    probs = torch.softmax(mm(x, p["router"]), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :K], idx[:, :K]
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    y = torch.zeros_like(x)
    for e in range(E):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        ye = swiglu(mm, x[rows], p["w_gate"][e], p["w_up"][e],
                    p["w_down"][e])
        y.index_add_(0, rows, ye * gate[rows, slot][:, None])
    return y


@torch.no_grad()
def logits_at(run, tree, tokens, rows, *, quant=None):
    """Logits [len(rows), vocab_size] in float32 of ``tokens`` (a list of
    ids) at positions ``rows``, from the weights ``tree`` (any type; each
    layer is taken to float32 as it is reached)."""
    mm = Matmul(quant)
    dev = tree["embed"].device
    with exact_float32():
        ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        h = tree["embed"][ids].float()
        for i in range(run["num_layers"]):
            p = wmod.layer(tree, i)
            h = h + attention(run, mm, p["attn"], norm(run, p["ln1"], h))
            x = norm(run, p["ln2"], h)
            h = h + (moe(run, mm, p["moe"], x) if run["family"] == "moe"
                     else swiglu(mm, x, p["mlp"]["w_gate"],
                                 p["mlp"]["w_up"], p["mlp"]["w_down"]))
            del p
        fn = {k: v.float() for k, v in tree["final_norm"].items()}
        hr = norm(run, fn, h[torch.as_tensor(rows, device=dev)])
        head = tree["embed"].T if run["tie_embeddings"] else tree["lm_head"]
        V = run["vocab_size"]
        return mm(hr, head[:, :V].float())
