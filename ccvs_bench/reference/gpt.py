"""Plain reference of the CCVS latent transformer: a minGPT over frame
tokens with a spatial and a temporal positional embedding ("temporal"
``emb_mode``), its next-token cross-entropy, AdamW with the trainer's decay
mask and one-step warmup, and the top-k rule of the token sampler.

A frozen copy written from the architecture (16lemoing/ccvs
``models/transformer_model.py``, minGPT), in plain PyTorch. It imports
nothing of the program under test; its parameters are a flat dict keyed as
the GPT's ``state_dict`` keys. Every product goes through ``q`` (operand
rounding: identity for the fp32 reference, fp8 for the control).
"""

import math

import torch
import torch.nn.functional as F


def check_supported(gpt):
    bad = [k for k in ("state", "p2p", "cat", "use_start_token", "stft", "deblurring", "layout",
                       "serve_int8", "remat", "seq_parallel", "fsdp", "finetune_head",
                       "lr_decay", "resid_noise") if gpt.get(k)]
    if bad or gpt.get("emb_mode", "temporal") != "temporal" or gpt.get("state_size", 0) \
            or gpt.get("grad_accum", 1) != 1:
        raise NotImplementedError(f"the reference GPT has no option {bad or gpt}")


def _linear(p, name, x, q, bias=True):
    return F.linear(q(x), q(p[name + ".weight"]), p[name + ".bias"] if bias else None)


def _ln(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], 1e-5)


def forward(p, gpt, code, q):
    """Logits ``(B, n, V)`` of frame tokens ``code`` ``(B, n)``: position ``j``
    has the spatial index ``j mod h*w`` and the temporal index ``j // h*w``;
    position ``j``'s logits predict token ``j + 1``."""
    b, n = code.shape
    size = gpt["z_shape"][0] * gpt["z_shape"][1]
    nh = gpt["n_head"]
    pos = torch.arange(n, device=code.device)
    x = p["tok_emb.weight"][code] + p["s_emb"][0][pos % size] + p["t_emb"][0][pos // size]
    causal = torch.ones(n, n, dtype=torch.bool, device=code.device).tril()
    for i in range(gpt["n_layer"]):
        name = f"core.blocks.{i}"
        h = _ln(p, name + ".ln1", x)
        qkv = [_linear(p, f"{name}.attn.{k}", h, q).reshape(b, n, nh, -1).transpose(1, 2)
               for k in ("query", "key", "value")]
        att = (q(qkv[0]) @ q(qkv[1]).transpose(-1, -2)) * (1.0 / math.sqrt(qkv[0].shape[-1]))
        att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
        y = (q(att) @ q(qkv[2])).transpose(1, 2).reshape(b, n, -1)
        x = x + _linear(p, name + ".attn.proj", y, q)
        h = F.gelu(_linear(p, name + ".fc1", _ln(p, name + ".ln2", x), q))
        x = x + _linear(p, name + ".fc2", h, q)
    return _linear(p, "head", _ln(p, "core.ln_f", x), q, bias=False)


def loss(p, gpt, code, q):
    """Mean next-token cross-entropy over the window ``code[:, :z_len]``."""
    code = code[:, :gpt["z_len"]]
    logits = forward(p, gpt, code[:, :-1], q)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), code[:, 1:].reshape(-1))


def decayed(name):
    """AdamW decays the weights of the dense layers (the attention and MLP
    projections and the head); embeddings, biases and LayerNorms do not."""
    return name.endswith(".weight") and (".attn." in name or ".fc" in name or name == "head.weight")


class AdamW:
    """AdamW as the trainer configures it: betas, eps 1e-8, decoupled weight
    decay on :func:`decayed` leaves, and a learning rate warmed up linearly
    from 0 over ``lr_warmup_iter`` updates (0 at the first update)."""

    @staticmethod
    def lr_at(gpt, count):
        warmup = max(gpt.get("lr_warmup_iter", 1), 1)
        return gpt["lr"] * min(count, warmup) / warmup

    def __init__(self, params, gpt):
        self.p = params
        self.b1, self.b2, self.wd = gpt["beta1"], gpt["beta2"], gpt["weight_decay"]
        self.gpt = gpt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        lr = self.lr_at(self.gpt, self.count)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, w in self.p.items():
            g = grads[k]
            if decayed(k):
                w.mul_(1 - lr * self.wd)
            self.m[k].lerp_(g, 1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            w.addcdiv_(self.m[k], self.v[k].sqrt() / math.sqrt(bc2) + 1e-8, value=-lr / bc1)


def steps_at_init(gpt, n_steps):
    """How many of ``n_steps`` steps run at the initial parameters: the
    first, and each after an update whose learning rate is still 0."""
    n = 1
    while n < n_steps and AdamW.lr_at(gpt, n - 1) == 0:
        n += 1
    return n


def train_steps(p, gpt, batches, q, micro=4):
    """Steps of the reference on ``batches`` of codes ``(B, n)``, from the
    parameters ``p`` (updated in place). Each step's gradient is the mean of
    its ``micro``-clip microbatches' (equal parts of the mean loss), so that
    fp32 activations fit. Returns the losses and the first step's gradient
    norm of every leaf."""
    opt = AdamW(p, gpt)
    losses, g1 = [], None
    for codes in batches:
        parts = codes.split(micro)
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        total = 0.0
        for part in parts:
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            lo = loss(leaves, gpt, part, q) / len(parts)
            lo.backward()
            total += float(lo.detach())
            for k, v in leaves.items():
                grads[k] += v.grad
        if g1 is None:
            g1 = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        losses.append(total)
        opt.step(grads)
    return losses, g1


def kth_logit(logits, k):
    """The ``k``-th largest logit of each row ``(..., V)``: the top-k sampler
    keeps exactly the tokens at or above it."""
    return torch.topk(logits, k, dim=-1).values[..., -1]
