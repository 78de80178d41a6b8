"""The plain reference of an RWKV-6 ("Finch", arXiv:2404.05892) training step,
and the benchmark's inputs for it: the weights and the token batches, made
on the device from the run seed.

Everything here is plain ``torch``: the time mix and the channel mix with
their token shift and data-dependent decay, the WKV recurrence

    y_t = r_t . (S + diag(u) k_t^T v_t),    S <- diag(exp(-exp(w_t))) S + k_t^T v_t,

(``wkv_loop``, its definition step by step; ``wkv``, the same in closed
form over chunks of steps, which the model runs), the next-token cross-entropy, gradients by autograd, the global-norm clip,
the warm-up-then-cosine learning rate and AdamW.  It imports nothing of the
program.  Each layer runs under ``torch.utils.checkpoint`` (only its input
is kept; the backward recomputes it), so the whole model fits one card
beside nothing else in float32.

``mode`` sets the precision: ``"config"`` (the reference: the
configuration's precisions, as its file states them: the weights cast to
the compute dtype each step but ``float32_leaves``, every product, the
residual stream, the token shift, k, v, g and the logits in bfloat16 with
float32 accumulation, r (a product with the float32 ``wr``), wlog, the
recurrence and its state, the norms' statistics, the group norm and the
cross-entropy in float32; TF32 off for matmul and cuDNN); ``"float32"``
(every tensor and product in float32; float64 weights give the same in
float64); and the controls one rung below the configuration:
``"bf16_compute"`` (the weights and AdamW's state in float32, the
configuration's float32 parts in bfloat16 too), ``"bfloat16"`` (the same
with the weights and AdamW's state in bfloat16) and ``"fp8"`` (the
configuration's bfloat16 products with their operands rounded to float8
e4m3 at a per-tensor scale).  ``bonus=False`` leaves the u term out of
the recurrence (a control); ``rows`` trains on the first ``rows``
sequences of each batch (a fault: half the batch); ``dwlog=False`` returns
zeros for the recurrence's gradient of wlog (a fault of its backward).

Departures from the paper, each the program's as well (it is what the
configuration runs): the norms are RMSNorm (``x * rsqrt(mean(x^2) + 1e-6) *
(1 + scale)``) where RWKV-6 has LayerNorm, and there is no LayerNorm after
the embedding; the token shift mixes with a static per-channel ``mu`` for
r, k, v, w and g (RWKV-5's lerp), where RWKV-6 makes it data dependent
through a second LoRA; the channel mix has no receptance gate (``relu(x
W_k)^2 W_v``); the output group norm is per head with eps 1e-5 (``GN_EPS``;
RWKV-6's ln_x has 1e-5 x 8^2) and a scale but no bias.  Weight decay follows the program's rule ``p.ndim >= 2``, which
on the layer-stacked leaves also decays the norms' scales and the per-channel
vectors.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0   # the largest float8 e4m3 value
CHUNK = 32        # steps of the recurrence computed together
GN_EPS = 1e-5     # the output group norm's epsilon, as the program's


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for the input stream ``stream`` of the run
    ``seed`` (any whole number)."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), *stream]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


# ------------------------------------------------------------- the inputs

def init_params(model: dict, seed: int, device) -> dict:
    """The run's float32 weights, drawn on ``device`` from ``seed`` in one
    call a leaf, in the program's layout (a leading layer axis on every leaf
    under ``"layers"``): the program's distributions (normal weights of std
    scale / sqrt(fan-in), the output projections scaled by 1 / sqrt(layers),
    the decay LoRA's second factor by 0.1, the token-shift mixes uniform in
    [0, 1), the decay base -0.6, the bonus u of std 0.1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 0))
    L, D, Fd, V = (model[k] for k in ("n_layers", "d_model", "d_ff",
                                      "vocab_size"))
    R = model["rwkv_decay_lora"]
    f32 = dict(dtype=torch.float32, device=device)
    out = 1.0 / math.sqrt(L)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, **f32).mul_(std)

    def uniform(shape):
        return torch.rand(shape, generator=gen, **f32)

    return {
        "embed": {"tok": normal((V, D), 0.02)},
        "final_norm": {"scale": torch.zeros(D, **f32)},
        "lm_head": {"wlm": normal((D, V), D ** -0.5)},
        "layers": {
            "ln_t": {"scale": torch.zeros((L, D), **f32)},
            "ln_c": {"scale": torch.zeros((L, D), **f32)},
            "mu": uniform((L, 5, D)),
            "wr": normal((L, D, D), D ** -0.5),
            "wk": normal((L, D, D), D ** -0.5),
            "wv": normal((L, D, D), D ** -0.5),
            "wg": normal((L, D, D), D ** -0.5),
            "wo": normal((L, D, D), D ** -0.5 * out),
            "w0": torch.full((L, D), -0.6, **f32),
            "wa": normal((L, D, R), D ** -0.5),
            "wb": normal((L, R, D), R ** -0.5 * 0.1),
            "u": normal((L, D), 0.1),
            "gn_scale": torch.ones((L, D), **f32),
            "mu_ck": uniform((L, D)),
            "wck": normal((L, D, Fd), D ** -0.5),
            "wcv": normal((L, Fd, D), Fd ** -0.5 * out),
        },
    }


def batch_tokens(model: dict, traffic: dict, seed: int, step: int,
                 device) -> torch.Tensor:
    """Step ``step``'s batch, (batch, seq + 1) int32 tokens on ``device``:
    token ids drawn independently with Zipf frequencies (rank k with weight
    (k + 1)^-s, ``zipf_exponent`` s), as words are in text."""
    V = model["vocab_size"]
    B, S = traffic["batch"], traffic["seq"]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 1, step))
    ranks = torch.arange(1, V + 1, dtype=torch.float64, device=device)
    probs = ranks.pow(-float(traffic["zipf_exponent"])).float()
    ids = torch.multinomial(probs, B * (S + 1), replacement=True,
                            generator=gen)
    return ids.view(B, S + 1).to(torch.int32)


def leaves(tree: dict, prefix: str = "") -> dict:
    """``{"layers.wr": tensor, ...}``: a nested dict's leaves by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def norms(names, tensors) -> dict:
    """The float64 norm of each of ``tensors`` (an iterable, taken one at a
    time) by its name in ``names``, read back to the host once."""
    with torch.no_grad():
        out = torch.stack([torch.linalg.vector_norm(t.float())
                           for t in tensors])
    return dict(zip(names, out.double().cpu().tolist()))


def nest(names, tensors) -> dict:
    """The nested dict whose leaves by path (``leaves``) are ``tensors``."""
    out: dict = {}
    for name, t in zip(names, tensors):
        *path, key = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[key] = t
    return out


def leaf_norms(tree: dict) -> dict:
    """The float64 norm of every leaf, by path."""
    flat = leaves(tree)
    return norms(list(flat), flat.values())


# ------------------------------------------------------------- the model

class _NoGrad(torch.autograd.Function):
    """x; its gradient returned as zeros."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


class _Fp8(torch.autograd.Function):
    """x rounded to float8 e4m3 at the scale that maps its largest |x| to
    the format's largest value; gradients pass through."""

    @staticmethod
    def forward(ctx, x):
        scale = FP8_MAX / x.abs().amax().float().clamp(min=1e-30)
        q = (x.float() * scale).to(torch.float8_e4m3fn)
        return (q.float() / scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def _product(a, b, low: bool, mode: str):
    """``a @ b`` in the wider of the two dtypes (a bfloat16 @ float32
    product is float32); in ``"fp8"`` mode a product the configuration runs
    in its compute dtype (``low``) takes float8 operands."""
    if mode == "fp8" and low:
        a, b = _Fp8.apply(a), _Fp8.apply(b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _rms(x, scale, wide, eps: float = 1e-6):
    """RMSNorm, its statistics and scale in ``wide``, returned in x's
    dtype."""
    y = x.to(wide)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.to(wide))).to(x.dtype)


def _shift(x):
    """Token shift: each position sees the one before it (zeros first)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def wkv_loop(r, k, v, wlog, u, bonus: bool = True):
    """The WKV recurrence as its definition, a step at a time from a zero
    state: r, k, v, wlog (B, S, H, dh), u (H, dh) -> y (B, S, H, dh)."""
    B, S, H, dh = r.shape
    state = r.new_zeros((B, H, dh, dh))
    decay = torch.exp(-torch.exp(wlog))
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # k_t^T v_t
        att = state + u[None, :, :, None] * kv if bonus else state
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], att))
        state = decay[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1)


def wkv(r, k, v, wlog, u, bonus: bool = True, chunk: int = CHUNK):
    """``wkv_loop``'s recurrence, ``chunk`` steps at a time: with c_t the
    sum of the log decays -exp(wlog) over the chunk's steps up to t, step
    s's k_s^T v_s reaches y_t (s < t) through exp(c_{t-1} - c_s) and the
    chunk's start state through exp(c_{t-1}), per key channel; every
    exponent is at most 0.  A chunk is a few batched products, where the
    loop's 512 steps are thousands of small launches (the reference's time
    is paid by every run)."""
    B, S, H, dh = r.shape
    r, k, v = (t.transpose(1, 2) for t in (r, k, v))          # (B, H, S, dh)
    logw = -torch.exp(wlog).transpose(1, 2)
    state = r.new_zeros((B, H, dh, dh))
    ys = []
    for a in range(0, S, chunk):
        rc, kc, vc, lc = (t[:, :, a:a + chunk] for t in (r, k, v, logw))
        T = rc.shape[2]
        cum = torch.cumsum(lc, dim=2)                          # c_t
        before = cum - lc                                      # c_{t-1}
        y = (rc * torch.exp(before)) @ state
        earlier = torch.ones((T, T), dtype=torch.bool,
                             device=r.device).tril(-1)[..., None]   # s < t
        gap = before[:, :, :, None, :] - cum[:, :, None, :, :]     # (t, s)
        decay = torch.exp(torch.where(earlier, gap, float("-inf")))
        att = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, decay)
        y = y + att @ vc
        if bonus:
            y = y + (rc * u[None, :, None, :] * kc).sum(-1, keepdim=True) \
                * vc
        ys.append(y)
        last = cum[:, :, -1:]
        state = torch.exp(last).transpose(-1, -2) * state \
            + (kc * torch.exp(last - cum)).transpose(-1, -2) @ vc
    return torch.cat(ys, dim=2).transpose(1, 2)


def _layer(lp: dict, x, model: dict, low: dict, mode: str, bonus: bool,
           dwlog: bool = True):
    """One layer: x plus its time mix, then plus its channel mix.  ``x``
    and the weights of ``low`` come in the compute dtype, the others in the
    wide one; the norms' statistics, r (a product with the wide ``wr``),
    wlog, the recurrence and the group norm run in the wide dtype."""
    B, S, D = x.shape
    dh = model["rwkv_head_dim"]
    H = D // dh
    wide = lp["w0"].dtype

    def mm(a, key):
        return _product(a, lp[key], low[key], mode)

    h = _rms(x, lp["ln_t"]["scale"], wide)
    hp = _shift(h)
    xr, xk, xv, xw, xg = (h + lp["mu"][i] * (hp - h) for i in range(5))
    r = mm(xr, "wr").view(B, S, H, dh)
    k = mm(xk, "wk").view(B, S, H, dh)
    v = mm(xv, "wv").view(B, S, H, dh)
    g = F.silu(mm(xg, "wg"))
    wlog = (lp["w0"] + mm(torch.tanh(mm(xw, "wa")), "wb").to(wide)) \
        .view(B, S, H, dh)
    if not dwlog:
        wlog = _NoGrad.apply(wlog)
    y = wkv(r.to(wide), k.to(wide), v.to(wide), wlog,
            lp["u"].view(H, dh).to(wide), bonus)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = ((y - mean) * torch.rsqrt(var + GN_EPS)).reshape(B, S, D) \
        * lp["gn_scale"].to(wide)
    x = x + mm(y.to(x.dtype) * g, "wo")
    h = _rms(x, lp["ln_c"]["scale"], wide)
    xk = h + lp["mu_ck"] * (_shift(h) - h)
    return x + mm(torch.square(F.relu(mm(xk, "wck"))), "wcv")


def precisions(mode: str, base: torch.dtype, model: dict):
    """(compute, wide) dtypes of ``mode`` for weights of dtype ``base``:
    ``"float32"`` runs all in ``base``; ``"config"`` and ``"fp8"`` run the
    configuration's ``compute_dtype`` with its wide parts in ``base``;
    ``"bf16_compute"`` and ``"bfloat16"`` run all in bfloat16."""
    if mode in ("config", "fp8"):
        return getattr(torch, model["compute_dtype"]), base
    if mode in ("bf16_compute", "bfloat16"):
        return torch.bfloat16, torch.bfloat16
    return base, base


def loss(params: dict, tokens, model: dict, *, mode: str = "float32",
         bonus: bool = True, dwlog: bool = True):
    """The mean next-token cross-entropy of ``tokens`` (B, S + 1).  Each
    weight goes to the compute dtype, those of ``float32_leaves`` to the
    wide one (as the program casts them each step; the cast's gradient
    returns to the weight's own dtype)."""
    keep = set(model["float32_leaves"])
    flat = leaves(params)
    compute, wide = precisions(mode, flat["layers.w0"].dtype, model)
    params = nest(list(flat), (p.to(wide if k.split(".")[-1] in keep
                                    else compute)
                               for k, p in flat.items()))
    low = {k: k not in keep for k in params["layers"]}
    tokens = tokens.long()
    x = params["embed"]["tok"][tokens[:, :-1]]
    L = params["layers"]["wr"].shape[0]
    for i in range(L):
        lp = {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                  else v[i]) for k, v in params["layers"].items()}
        x = checkpoint(_layer, lp, x, model, low, mode, bonus, dwlog,
                       use_reentrant=False)
    x = _rms(x, params["final_norm"]["scale"], wide)
    logits = _product(x, params["lm_head"]["wlm"], True, mode).to(wide)
    logits = logits.reshape(-1, logits.shape[-1])
    gold = tokens[:, 1:].reshape(-1)
    return torch.mean(torch.logsumexp(logits, dim=-1)
                      - logits.gather(1, gold[:, None])[:, 0])


# ------------------------------------------------------------- training

def learning_rate(step: int, base_lr: float, warmup: int, total_steps: int,
                  min_frac: float) -> float:
    """Linear warm-up from 0 at step 0 over ``warmup`` steps, then a cosine
    to ``min_frac`` of ``base_lr`` at ``total_steps``."""
    w = min(step / max(warmup, 1), 1.0)
    t = min(max(step - warmup, 0) / max(total_steps - warmup, 1), 1.0)
    return base_lr * w * (min_frac + (1 - min_frac) * 0.5
                          * (1 + math.cos(math.pi * t)))


@contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def train(model: dict, traffic: dict, params0: dict, batches: list, *,
          mode: str = "float32", bonus: bool = True, rows: int | None = None,
          dwlog: bool = True) -> dict:
    """The steps of ``batches`` from ``params0`` (float32, left as they
    are): each step's loss and global gradient norm before the clip;
    AdamW's first moment of every leaf after the first step (``"moments"``:
    1 - b1 times the first gradient as AdamW gets it, after the clip); and
    every leaf's norm of its change over all the steps."""
    opt = traffic["adamw"]
    b1, b2, eps, wd = (opt[k] for k in ("b1", "b2", "eps", "weight_decay"))
    dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
    names = list(leaves(params0))
    start = list(leaves(params0).values())
    ps = [p.detach().to(dt).clone() for p in start]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]

    out = {"losses": [], "gnorms": []}
    with no_tf32():
        for step, tokens in enumerate(batches):
            if rows is not None:
                tokens = tokens[:rows]
            ps = [p.requires_grad_() for p in ps]
            with torch.enable_grad():
                value = loss(nest(names, ps), tokens, model, mode=mode,
                             bonus=bonus, dwlog=dwlog)
                grads = torch.autograd.grad(value, ps, allow_unused=True)
            # a leaf the loss does not reach (u, with the bonus left out)
            # has a zero gradient
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(ps, grads)]
            out["losses"].append(float(value.detach()))
            with torch.no_grad():
                gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                out["gnorms"].append(float(gn))
                scale = torch.clamp(traffic["clip_norm"]
                                    / torch.clamp(gn, min=1e-9), max=1.0)
                lr = learning_rate(step, traffic["base_lr"],
                                   traffic["warmup"], traffic["total_steps"],
                                   traffic["min_lr_frac"])
                c = step + 1
                bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
                new = []
                for i, (p, g) in enumerate(zip(ps, grads)):
                    g = g * scale
                    ms[i] = b1 * ms[i] + (1 - b1) * g
                    vs[i] = b2 * vs[i] + (1 - b2) * g * g
                    upd = (ms[i] / bc1) / (torch.sqrt(vs[i] / bc2) + eps)
                    if p.ndim >= 2:
                        upd = upd + wd * p
                    new.append((p - lr * upd).detach())
                ps = new
                del grads
                if step == 0:
                    out["moments"] = dict(zip(names, ms))
        out["change_norms"] = norms(names, (p.float() - p0 for p, p0
                                            in zip(ps, start)))
    return out
