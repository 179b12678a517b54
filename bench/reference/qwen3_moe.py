"""Plain Qwen3-MoE training steps: the forward, the loss, its gradients and
AdamW, in fp32 with TF32 off. Imports nothing of the program.

The architecture as the port runs it (``models/lm.py``, ``layers.py``,
``moe.py``), each layer:

    h  = RMSNorm(x)
    q, k, v = h·Wq, h·Wk, h·Wv, split into heads (GQA: 32 query, 4 KV)
    q, k = RMSNorm over head_dim, then RoPE (rotate-half, θ)
    x += softmax(q·kᵀ/√d, causal)·v ·Wo
    h2 = RMSNorm(x)
    p  = softmax(h2·W_router); the top 8 experts, weights renormalised
    x += Σ_k w_k · (silu(h2·W_gate[e_k]) ⊙ h2·W_up[e_k]) · W_down[e_k]

then logits = RMSNorm(x)·W_head, the loss the mean next-token cross
entropy plus ``router_aux_loss_coef`` × Σ_layers E·Σ_e f_e·P_e (f_e the
share of tokens whose first choice is e, P_e the mean router
probability). Every RMSNorm takes the configuration's ``rms_norm_eps``, as
the published model does.

Dropless routing with every expert's rows, as the port's ``moe_impl=
"cuda"``; each layer is recomputed in the backward and the loss is taken
in blocks of tokens, so that the fp32 step fits beside the optimizer's
state. AdamW as the port's ``optim/adamw.py``: a global-norm clip, bias
corrections, ``u = m̂/(√v̂ + eps) + wd·p``, ``p -= lr·u``; a leaf
stored in bf16 is rounded to bf16 after each update, as the configuration
stores it.

``precision="fp8"`` is the control: every product the configuration runs
in bf16 takes e4m3 operands (per-tensor absmax scale) and an e5m2 output
gradient, every product it runs in fp32 (the router, attention's scores
and values) bf16 operands.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from . import full_fp32

LOSS_BLOCK = 1024               # tokens a block of the loss
FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}


# ---------------------------------------------------------------------------
# the parameters, named as the program names them
# ---------------------------------------------------------------------------

def param_specs(cfg: dict) -> list:
    """(name, shape, dtype, std) of every parameter; std None: ones. The
    weights, in the configuration's ``torch_dtype``, draw N(0, std²) (the
    embedding 0.02, a projection 1/√d_in, the experts' down projection a
    quarter of that); the norms and the router are fp32."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    e, f, v = cfg["num_experts"], cfg["moe_intermediate_size"], \
        padded_vocab(cfg)
    bf, fp = cfg["torch_dtype"], "float32"
    specs = [("embed.table", (v, d), bf, 0.02),
             ("final_norm.scale", (d,), fp, None),
             ("lm_head", (d, v), bf, 1 / math.sqrt(d))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        specs += [
            (p + "norm1.scale", (d,), fp, None),
            (p + "mixer.wq", (d, q), bf, 1 / math.sqrt(d)),
            (p + "mixer.wk", (d, kv), bf, 1 / math.sqrt(d)),
            (p + "mixer.wv", (d, kv), bf, 1 / math.sqrt(d)),
            (p + "mixer.wo", (q, d), bf, 1 / math.sqrt(q)),
            (p + "mixer.q_norm", (hd,), fp, None),
            (p + "mixer.k_norm", (hd,), fp, None),
            (p + "norm2.scale", (d,), fp, None),
            (p + "ffn.router", (d, e), fp, 1 / math.sqrt(d)),
            (p + "ffn.w_up", (e, d, f), bf, 1 / math.sqrt(d)),
            (p + "ffn.w_gate", (e, d, f), bf, 1 / math.sqrt(d)),
            (p + "ffn.w_down", (e, f, d), bf, 1 / math.sqrt(d) / 4),
        ]
    return specs


def padded_vocab(cfg: dict) -> int:
    return (cfg["vocab_size"] + 127) // 128 * 128


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------

def _fake(x, fmt: str):
    """x rounded to ``fmt`` and back to fp32 (fp8: per-tensor absmax
    scale)."""
    if fmt == "bf16":
        return x.to(torch.bfloat16).float()
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX[fmt]
    dt = torch.float8_e4m3fn if fmt == "e4m3" else torch.float8_e5m2
    return (x / scale).to(dt).float() * scale


class _Round(torch.autograd.Function):
    """Forward: the value rounded to ``fwd``; backward: the gradient rounded
    to ``bwd`` (None: passed through)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return x if fwd is None else _fake(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.bwd is None else _fake(g, ctx.bwd)), None, None


class Products:
    """The matmuls of the model at a precision: ``"fp32"`` (the reference)
    or ``"fp8"`` (the control, see the module docstring). ``kind`` is the
    precision the configuration runs a product in: "bf16" or "fp32"."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def operands(self, kind, *xs):
        if self.precision == "fp32":
            return xs
        fmt = "e4m3" if kind == "bf16" else "bf16"
        return tuple(_Round.apply(x, fmt, None) for x in xs)

    def output(self, kind, y):
        if self.precision == "fp32" or kind != "bf16":
            return y
        return _Round.apply(y, None, "e5m2")

    def mm(self, a, b, kind="bf16"):
        a, b = self.operands(kind, a, b)
        return self.output(kind, a @ b)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x: (B, S, H, D), positions 0..S-1; the halves rotated."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(p, prm, h, cfg: dict, mm: Products):
    b, s, _ = h.shape
    nh, nkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    q = mm.mm(h, prm[p + "mixer.wq"]).reshape(b, s, nh, hd)
    k = mm.mm(h, prm[p + "mixer.wk"]).reshape(b, s, nkv, hd)
    v = mm.mm(h, prm[p + "mixer.wv"]).reshape(b, s, nkv, hd)
    eps = cfg["rms_norm_eps"]
    q = rope(rms_norm(q, prm[p + "mixer.q_norm"], eps), cfg["rope_theta"])
    k = rope(rms_norm(k, prm[p + "mixer.k_norm"], eps), cfg["rope_theta"])
    g = nh // nkv
    q = q.permute(0, 2, 1, 3)                                 # (B, H, S, D)
    k = k.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    v = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    q, kt = mm.operands("fp32", q / math.sqrt(hd), k.transpose(-1, -2))
    scores = q @ kt
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -1e30), dim=-1)
    probs, v = mm.operands("fp32", probs, v)
    out = (probs @ v).permute(0, 2, 1, 3).reshape(b, s, nh * hd)
    return mm.mm(out, prm[p + "mixer.wo"])


def moe(p, prm, h, cfg: dict, mm: Products):
    """Dropless top-k experts over the (B·S, d) rows; returns the output and
    the layer's load-balance aux."""
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(mm.mm(x, prm[p + "ffn.router"], "fp32"), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    if cfg["norm_topk_prob"]:
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    frac_tokens = F.one_hot(top_e[:, 0], e).float().mean(0)
    aux = e * torch.sum(frac_tokens * probs.mean(0))
    flat_e = top_e.reshape(-1)
    tok = torch.arange(b * s, device=h.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e).tolist()
    xs = x.index_select(0, tok[order])
    wu, wg, wd = (prm[p + "ffn.w_up"], prm[p + "ffn.w_gate"],
                  prm[p + "ffn.w_down"])
    outs, lo = [], 0
    for ex, n in enumerate(counts):
        if n:
            xe = xs[lo:lo + n]
            he = F.silu(mm.mm(xe, wg[ex])) * mm.mm(xe, wu[ex])
            outs.append(mm.mm(he, wd[ex]))
            lo += n
    ys = torch.cat(outs) * top_p.reshape(-1)[order][:, None]
    out = torch.zeros_like(x).index_add(0, tok[order], ys)
    return out.reshape(b, s, d), aux


def block(i: int, prm, x, cfg: dict, mm: Products):
    p, eps = f"layers.{i}.", cfg["rms_norm_eps"]
    x = x + attention(p, prm, rms_norm(x, prm[p + "norm1.scale"], eps),
                      cfg, mm)
    f, aux = moe(p, prm, rms_norm(x, prm[p + "norm2.scale"], eps), cfg, mm)
    return x + f, aux


def _ce_sum(xb, labels, scale, head, eps: float, mm: Products):
    logits = mm.mm(rms_norm(xb, scale, eps), head)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss(prm, tokens, labels, cfg: dict, mm: Products):
    """The mean next-token cross entropy plus the weighted MoE aux, with
    each layer and each block of the loss recomputed in the backward."""
    x = prm["embed.table"][tokens.long()]
    aux_total = torch.zeros((), device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        x, aux = ckpt.checkpoint(block, i, prm, x, cfg, mm,
                                 use_reentrant=False)
        aux_total = aux_total + aux
    d = x.shape[-1]
    flat, lab = x.reshape(-1, d), labels.reshape(-1).long()
    total = torch.zeros((), device=x.device)
    for lo in range(0, flat.shape[0], LOSS_BLOCK):
        total = total + ckpt.checkpoint(
            _ce_sum, flat[lo:lo + LOSS_BLOCK], lab[lo:lo + LOSS_BLOCK],
            prm["final_norm.scale"], prm["lm_head"], cfg["rms_norm_eps"], mm,
            use_reentrant=False)
    return total / flat.shape[0] + cfg["router_aux_loss_coef"] * aux_total


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

def adamw_step(prm, grads, state, step: int, opt: dict, stored: dict):
    """One AdamW update of ``prm`` in place (fp32 leaves); ``stored[name]``
    the dtype a leaf is kept in (bf16 leaves rounded after the update)."""
    gnorm = torch.sqrt(sum(torch.sum(g.square()) for g in grads.values()))
    clip = torch.clamp(opt["grad_clip"] / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    t = step + 1
    bc1 = 1.0 - opt["b1"] ** t
    bc2 = 1.0 - opt["b2"] ** t
    with torch.no_grad():
        for name, p in prm.items():
            g = grads[name] * clip
            m, v = state[name]
            m.mul_(opt["b1"]).add_((1.0 - opt["b1"]) * g)
            v.mul_(opt["b2"]).add_(g.square() * (1.0 - opt["b2"]))
            u = (m / bc1) / ((v / bc2).sqrt() + opt["eps"])
            u = (u + p * opt["weight_decay"]) * opt["lr"]
            p.sub_(u)
            if stored[name] == "bfloat16":
                p.copy_(p.to(torch.bfloat16).float())


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def train_steps(cfg: dict, weights: dict, batches, opt: dict,
                precision: str = "fp32") -> dict:
    """Follow ``len(batches)`` steps from ``weights`` (the benchmark's
    initial leaves, any dtype; not modified): returns each step's loss,
    each leaf's first clipped gradient's norm, and each leaf's change
    after the last step (norms accumulated in fp64)."""
    stored = {n: dt for n, _, dt, _ in param_specs(cfg)}
    mm = Products(precision)
    out = {"loss": [], "first_grad_norm": {}, "change_norm": {}}
    with full_fp32():
        prm = {n: w.detach().float().clone().requires_grad_()
               for n, w in weights.items()}
        names = list(prm)
        state = {n: (torch.zeros_like(p), torch.zeros_like(p))
                 for n, p in prm.items()}
        for step, batch in enumerate(batches):
            value = loss(prm, batch["tokens"], batch["labels"], cfg, mm)
            grads = dict(zip(names, torch.autograd.grad(
                value, [prm[n] for n in names])))
            out["loss"].append(float(value.detach()))
            del value
            with torch.no_grad():
                adamw_step(prm, grads, state, step, opt, stored)
            del grads
            if step == 0:
                out["first_grad_norm"] = {
                    n: _norm(state[n][0]) / (1.0 - opt["b1"]) for n in names}
        with torch.no_grad():
            for n, p in prm.items():
                out["change_norm"][n] = _norm(p - weights[n].float())
    return out
