"""Model FLOPs of the cells' work, from the configuration's and the
traffic's shapes alone.

A FLOP here is what ``torch.utils.flop_counter.FlopCounterMode`` counts:
two for each multiply-add of a matrix product or a convolution (full
attention products, depthwise blurs and grouped upsamplers included;
elementwise work, the cost volume's products, the warps and the softmax
not). The counts follow the plain reference's structure (``reference/``);
``tests/test_bench_counts.py`` holds them to ``FlopCounterMode`` over it.
"""

from ccvs_bench.reference import ae as ref_ae


def conv(n, cout, cin, k, h, w=None):
    """A convolution of ``n`` images, ``cin`` (per group) to ``cout``
    channels, ``k x k``, at ``h x w`` outputs."""
    return 2 * n * cout * cin * k * k * h * (h if w is None else w)


def conv_t(n, cin, cout, k, h):
    """A transposed convolution read at ``h x h`` inputs (FlopCounterMode's rule)."""
    return 2 * n * cin * cout * k * k * h * h


def blur(n, c, h):
    """The depthwise 4x4 blur at ``h x h`` outputs."""
    return conv(n, c, 1, 4, h)


# ---------------------------------------------------------------- GPT

def gpt_forward(gpt, b, n):
    """A forward of ``b`` sequences of ``n`` tokens: the four attention
    projections and the MLP (``24 b n d^2`` a layer), the full attention
    products (``4 b n^2 d``) and the head."""
    d, v = gpt["n_embd"], max(gpt["z_num"], gpt.get("state_num", 0))
    return gpt["n_layer"] * (24 * b * n * d * d + 4 * b * n * n * d) + 2 * b * n * d * v


def gpt_decode_step(gpt, b, pos):
    """One cached decode step of ``b`` rows at position ``pos`` (attention
    over positions ``0..pos``)."""
    d, v = gpt["n_embd"], max(gpt["z_num"], gpt.get("state_num", 0))
    return gpt["n_layer"] * (24 * b * d * d + 4 * b * (pos + 1) * d) + 2 * b * d * v


# ---------------------------------------------------------------- autoencoder

def _res_down(n, cin, cout, h):
    """A downsampling residual block at ``h x h`` inputs."""
    return (conv(n, cin, cin, 3, h) + blur(n, cin, h + 1) + conv(n, cout, cin, 3, h // 2)
            + blur(n, cin, h - 1) + conv(n, cout, cin, 1, h // 2))


def _res_up(n, cin, cout, h):
    """An upsampling residual block at ``h x h`` inputs."""
    return (conv(n, cin, cin, 3, h) + conv_t(n, cin, cout, 3, h) + blur(n, cout, 2 * h)
            + conv_t(n, cin, cout, 1, h) + blur(n, cout, 2 * h))


def encode(ae, n):
    """The encoder over ``n`` frames."""
    enc, h = ref_ae.enc_channels(ae), ae["max_dim"]
    total = conv(n, enc[0], 3, 1, h)
    for i in range(1, len(enc)):
        total += _res_down(n, enc[i - 1], enc[i], h)
        h //= 2
    return total + conv(n, ae["z_size"], enc[-1], 1, h)


def _flow_convs(nk, cin, kernel, h):
    return (conv(nk, 128, cin, 3, h) + conv(nk, 64, 128, 3, h) + conv(nk, 32, 64, 3, h)
            + conv(nk, 2, 32, kernel, h) + conv(nk, 1, 32, kernel, h))


def _inter_block(n, k, fs, sch, h, first):
    kernel, _, s = sch
    nk, hs = n * k, -(-h // s)
    total = 0
    if not first:
        total += conv_t(nk, 2, 1, 4, h // 2) + conv_t(nk, 1, 1, 4, h // 2)
    if fs > 16:
        total += conv(n + nk, max(16, fs // 4), fs, 1, hs)
    if s != 1:
        total += conv_t(nk, 49, 1, 4, hs)
    return total + _flow_convs(nk, 49, kernel, h) + _flow_convs(nk, 2 * fs + 3, kernel, h)


def decode(ae, n, k):
    """The decoder over ``n`` frames, each against ``k`` context slots."""
    dec, sizes = ref_ae.dec_channels(ae), ref_ae.inter_sizes_dec(ae)
    nres = len(dec)
    h = ae["max_dim"] >> (nres - 1)
    total = conv(n, dec[0], ae["z_size"], 1, h)
    for i, sch in enumerate(ref_ae.schedule(nres)):
        if i > 0:
            total += _res_up(n, dec[i - 1], dec[i], h)
            h *= 2
        total += _inter_block(n, k, sizes[i], sch, h, i == 0)
    return total + conv(n, 3, dec[-1], 1, h)


def decode_video(ae, b, t):
    """The rollout decode of ``b`` clips of ``t`` frames from one context
    frame: its encode and decode, then each later frame decoded against the
    FIFO and re-encoded."""
    total = encode(ae, b) + decode(ae, b, 1)
    for curr in range(1, t):
        total += decode(ae, b, min(curr, ae["skip_memory"])) + encode(ae, b)
    return total


# ---------------------------------------------------------------- cells' work

def train_step(cfg, b, t):
    """One transformer training step on ``b`` clips of ``t`` frames: the
    frozen encode and the GPT's forward and backward (three forwards) over
    the ``t * h * w - 1`` input tokens."""
    gpt = cfg["gpt"]
    n = min(t * gpt["z_shape"][0] * gpt["z_shape"][1], gpt["z_len"]) - 1
    return encode(cfg["ae"], b * t) + 3 * gpt_forward(gpt, b, n)


def rollout(cfg, b, t, n_ctx):
    """One ``generate`` of ``b`` clips of ``t`` frames from ``n_ctx`` context
    frames, in one window: the clips' encode, the prefill of the whole
    window, a decode step at every position past the context, and the
    rollout decode."""
    gpt = cfg["gpt"]
    size = gpt["z_shape"][0] * gpt["z_shape"][1]
    length = t * size
    if length > gpt["z_len"] or n_ctx != 1:
        raise NotImplementedError("one window, one context frame")
    steps = sum(gpt_decode_step(gpt, b, p) for p in range(n_ctx * size, length))
    return (encode(cfg["ae"], b * t) + gpt_forward(gpt, b, length) + steps
            + decode_video(cfg["ae"], b, t))
