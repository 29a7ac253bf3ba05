"""Adaptive discriminator augmentation (ADA): StyleGAN2-ADA's non-leaking
augmentation (counterpart of ``ccvs_tpu/train/ada.py``, the reference's
``modules/non_leaking.py``), NHWC.

- :func:`sample_affine` / :func:`sample_color`: the random transform cascade
  (flip, 90-degree rotation, integer translation, isotropic and anisotropic
  scale, pre- and post-rotation, fractional translation; brightness,
  contrast, luma flip, hue rotation, saturation), each applied to an image
  with probability ``p``. Each is two functions: :func:`draw_affine` /
  :func:`draw_color` draw the raw numbers from a ``torch.Generator``, and
  :func:`build_affine` / :func:`build_color` build the matrices from them,
  so the matrices can be built from any draws (the JAX package's, in the
  tests).
- :func:`augment`: the geometric warp on a 2x canvas, between sym6-wavelet
  up- and downsampling (``upfirdn2d``) around a bilinear sample
  (:func:`~ccvs_tpu_torch.ops.warp.bilinear_sample`, which R1's double
  backward can differentiate twice), then the colour matrix.

``p`` is a device tensor (the adaptive probability the D step's controller
tunes, ``train/steps.py``) or a number; nothing here reads it on the host.
The canvas takes a fixed reflect pad of a quarter of each side, as the JAX
package's does (the reference pads per batch from the sampled matrices).
"""

import math

import torch
import torch.nn.functional as F

from ccvs_tpu_torch.ops.upfirdn2d import upfirdn2d
from ccvs_tpu_torch.ops.warp import bilinear_sample

SYM6 = (0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
        -0.048311742585633, 0.4910559419267466, 0.787641141030194,
        0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
        0.04472490177066578, 0.0017677118642428036, -0.007800708325034148)


def _mat3(a00, a01, a02, a10, a11, a12):
    """``(B, 3, 3)`` affine matrices from their top two rows."""
    z, o = torch.zeros_like(a00), torch.ones_like(a00)
    return torch.stack([a00, a01, a02, a10, a11, a12, z, z, o], -1).view(-1, 3, 3)


def _translate(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat3(o, z, tx, z, o, ty)


def _rotate(theta):
    z, c, s = torch.zeros_like(theta), torch.cos(theta), torch.sin(theta)
    return _mat3(c, -s, z, s, c, z)


def _scale(sx, sy):
    z = torch.zeros_like(sx)
    return _mat3(sx, z, z, z, sy, z)


def _apply(u, p, mat, prev):
    """``mat @ prev`` for the items whose uniform ``u`` is below ``p`` (the
    JAX package's ``bernoulli``), ``prev`` for the others."""
    sel = (u < p).float()[:, None, None]
    eye = torch.eye(mat.shape[-1], device=mat.device)
    return (sel * mat + (1 - sel) * eye) @ prev


def draw_affine(generator, b):
    """The affine cascade's raw numbers for ``b`` images, on ``generator``'s
    device: ``flip`` and ``rot90`` in {0, 1}, ``translate`` U(-0.125,
    0.125), ``iso`` and ``aniso`` N(0, 1), ``pre_rot`` and ``post_rot``
    U(-pi, pi), ``frac`` N(0, 1), each ``(b,)``; ``sel`` ``(8, b)`` U(0, 1),
    the uniform that selects each transform, in the cascade's order."""
    kw = dict(generator=generator, device=generator.device)

    def u(lo, hi):
        return torch.rand(b, **kw) * (hi - lo) + lo

    return {"flip": torch.randint(0, 2, (b,), **kw).float(),
            "rot90": torch.randint(0, 2, (b,), **kw).float(),
            "translate": u(-0.125, 0.125), "iso": torch.randn(b, **kw),
            "pre_rot": u(-math.pi, math.pi), "aniso": torch.randn(b, **kw),
            "post_rot": u(-math.pi, math.pi), "frac": torch.randn(b, **kw),
            "sel": torch.rand(8, b, **kw)}


def build_affine(d, p, height, width):
    """The ``(B, 3, 3)`` cascade of :func:`draw_affine`'s numbers ``d``
    (``non_leaking.py:192-249``): each transform applied where its
    selection uniform is below ``p``, the two free rotations below
    ``1 - sqrt(1 - p)``."""
    sel = d["sel"]
    b = sel.shape[1]
    one = torch.ones(b, device=sel.device)
    G = torch.eye(3, device=sel.device).expand(b, 3, 3)
    G = _apply(sel[0], p, _scale(1 - 2 * d["flip"], one), G)
    G = _apply(sel[1], p, _rotate(-math.pi / 2 * (d["rot90"] * 3)), G)
    t = d["translate"]
    G = _apply(sel[2], p, _translate(torch.round(t * width) / width,
                                     torch.round(t * height) / height), G)
    s = torch.exp(d["iso"] * (0.2 * math.log(2)))
    G = _apply(sel[3], p, _scale(s, s), G)
    p_rot = 1 - torch.sqrt(torch.clamp(1.0 - torch.as_tensor(p, device=sel.device), 0.0, 1.0))
    G = _apply(sel[4], p_rot, _rotate(-d["pre_rot"]), G)
    s = torch.exp(d["aniso"] * (0.2 * math.log(2)))
    G = _apply(sel[5], p, _scale(s, 1 / s), G)
    G = _apply(sel[6], p_rot, _rotate(-d["post_rot"]), G)
    t = d["frac"] * 0.125
    return _apply(sel[7], p, _translate(t, t), G)


def sample_affine(generator, p, b, height, width):
    """Random affine cascade (``non_leaking.py:192-249``), ``(b, 3, 3)``."""
    return build_affine(draw_affine(generator, b), p, height, width)


_AXIS = (1 / math.sqrt(3),) * 3


def _eye4(b, device):
    return torch.eye(4, device=device).expand(b, 4, 4)


def _translate3d(t):
    m = _eye4(t.shape[0], t.device).clone()
    m[:, :3, 3] = t[:, None]
    return m


def _scale3d(s):
    m = _eye4(s.shape[0], s.device).clone()
    m[:, [0, 1, 2], [0, 1, 2]] = s[:, None]
    return m


def _rotate3d(theta):
    dev = theta.device
    u = torch.tensor(_AXIS, device=dev)
    cross = torch.tensor([[0, -_AXIS[2], _AXIS[1]], [_AXIS[2], 0, -_AXIS[0]],
                          [-_AXIS[1], _AXIS[0], 0]], device=dev)
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    rot = c * torch.eye(3, device=dev) + s * cross + (1 - c) * torch.outer(u, u)
    m = _eye4(theta.shape[0], dev).clone()
    m[:, :3, :3] = rot
    return m


def _axis4(device):
    u = torch.tensor(_AXIS + (0.0,), device=device)
    return torch.outer(u, u)


def _luma_flip(i):
    return torch.eye(4, device=i.device) - 2.0 * _axis4(i.device) * i[:, None, None]


def _saturation(i):
    outer = _axis4(i.device)
    return outer + (torch.eye(4, device=i.device) - outer) * i[:, None, None]


def draw_color(generator, b):
    """The colour cascade's raw numbers for ``b`` images, on ``generator``'s
    device: ``brightness``, ``contrast`` and ``saturation`` N(0, 1),
    ``luma_flip`` in {0, 1}, ``hue`` U(-pi, pi), each ``(b,)``; ``sel`` ``(5,
    b)`` U(0, 1)."""
    kw = dict(generator=generator, device=generator.device)
    return {"brightness": torch.randn(b, **kw), "contrast": torch.randn(b, **kw),
            "luma_flip": torch.randint(0, 2, (b,), **kw).float(),
            "hue": torch.rand(b, **kw) * (2 * math.pi) - math.pi,
            "saturation": torch.randn(b, **kw), "sel": torch.rand(5, b, **kw)}


def build_color(d, p):
    """The ``(B, 4, 4)`` colour cascade of :func:`draw_color`'s numbers
    (``non_leaking.py:252-280``)."""
    sel = d["sel"]
    C = _eye4(sel.shape[1], sel.device)
    C = _apply(sel[0], p, _translate3d(d["brightness"] * 0.2), C)
    C = _apply(sel[1], p, _scale3d(torch.exp(d["contrast"] * (0.5 * math.log(2)))), C)
    C = _apply(sel[2], p, _luma_flip(d["luma_flip"]), C)
    C = _apply(sel[3], p, _rotate3d(d["hue"]), C)
    return _apply(sel[4], p, _saturation(torch.exp(d["saturation"] * math.log(2))), C)


def sample_color(generator, p, b):
    """Random colour-matrix cascade (``non_leaking.py:252-280``), ``(b, 4, 4)``."""
    return build_color(draw_color(generator, b), p)


def apply_color(img, C):
    """``(B, H, W, 3)`` through the colour matrices ``C`` ``(B, 4, 4)``
    (``non_leaking.py:449-459``)."""
    return torch.einsum("bhwc,bdc->bhwd", img, C[:, :3, :3]) + C[:, None, None, :3, 3]


def _diag3(a, b):
    return torch.tensor([[a, 0, 0], [0, b, 0], [0, 0, 1]], dtype=torch.float32)


def _trans3(a):
    return torch.tensor([[1, 0, a], [0, 1, a], [0, 0, 1]], dtype=torch.float32)


def apply_affine(img, G, kernel=SYM6, pad_frac=0.25):
    """Geometric warp of ``img`` ``(B, H, W, C)`` by ``G`` ``(B, 3, 3)``,
    which maps output to input coordinates (``non_leaking.py:388-447``):
    a reflect pad of ``pad_frac`` of each side, a 2x upsample with the
    separable wavelet ``kernel``, a bilinear sample of the canvas at
    ``G``'s coordinates, a 2x downsample with the flipped kernel (negative
    pads crop the canvas back to ``H x W``)."""
    b, h, w, _ = img.shape
    dev = img.device
    k = torch.tensor(kernel, dtype=torch.float32, device=dev)
    len_k = k.shape[0]
    pad_k = len_k // 4
    pad_x, pad_y = int(w * pad_frac), int(h * pad_frac)
    x = F.pad(img.permute(0, 3, 1, 2), (pad_x, pad_x, pad_y, pad_y),
              mode="reflect").permute(0, 2, 3, 1)

    up0, up1 = (len_k + 2 - 1) // 2, (len_k - 2) // 2
    x = upfirdn2d(x, k[None, :], up=(2, 1), pad=(up0, up1, 0, 0))
    x = upfirdn2d(x, k[:, None], up=(1, 2), pad=(0, 0, up0, up1))
    h2, w2 = x.shape[1:3]

    # the output pixel centres (align_corners=False) in input coordinates:
    # in = S(2/w2) T(-1/2) S(2) G S(1/2) T(1/2) S(size/2) out
    out_h, out_w = (h + pad_k * 2) * 2, (w + pad_k * 2) * 2
    ys = (2 * torch.arange(out_h, device=dev) + 1) / out_h - 1
    xs = (2 * torch.arange(out_w, device=dev) + 1) / out_w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    chain = (_diag3(2 / w2, 2 / h2) @ _trans3(-0.5) @ _diag3(2.0, 2.0)).to(dev)
    tail = (_diag3(0.5, 0.5) @ _trans3(0.5) @ _diag3(out_w / 2, out_h / 2)).to(dev)
    gn = torch.einsum("ij,bjk,kl->bil", chain, G, tail)
    grid = torch.einsum("nk,bik->bni", coords, gn)[..., :2].reshape(b, out_h, out_w, 2)
    x = bilinear_sample(x, grid)

    kf = torch.flip(k, (0,))
    d0 = -pad_k * 2 + (len_k - 2 + 1) // 2
    d1 = -pad_k * 2 + (len_k - 2) // 2
    x = upfirdn2d(x, kf[None, :], down=(2, 1), pad=(d0, d1, 0, 0))
    return upfirdn2d(x, kf[:, None], down=(1, 2), pad=(0, 0, d0, d1))


def augment(generator, img, p, draws=None):
    """ADA on ``img`` ``(B, H, W, 3)`` in [-1, 1] (``non_leaking.py:460-463``):
    the inverse of the sampled affine cascade as the warp, then the colour
    matrix, computed in fp32; returns ``img``'s dtype. ``draws``, when
    given, is ``(affine, colour)`` raw numbers used instead of drawing from
    ``generator``."""
    b, h, w, _ = img.shape
    if draws is None:
        draws = draw_affine(generator, b), draw_color(generator, b)
    p = torch.as_tensor(p, dtype=torch.float32, device=img.device)
    # inv_ex: the same inverse as ``linalg.inv`` without its host check for
    # singular matrices (the cascade's matrices are invertible)
    G = torch.linalg.inv_ex(build_affine(draws[0], p, h, w))[0]
    out = apply_affine(img.float(), G)
    return apply_color(out, build_color(draws[1], p)).to(img.dtype)
