"""Miscellaneous ops (counterpart of ``ccvs_tpu/ops/misc.py``), NHWC.

- :func:`nll_vMF`: the von Mises-Fisher negative log-likelihood
  (``modules/vmf.py:33-76``). Its normalising constant needs the
  exponentially scaled Bessel function, which scipy evaluates on the host,
  as the reference does on the CPU and the JAX package through
  ``pure_callback``; the gradient uses ``d/dk log C_m(k) = -I_{m/2}(k) /
  I_{m/2-1}(k)``.
- :func:`bilinear_interpolate` / :func:`nearest_interpolate`
  (``modules/interpolate.py``): upsampling by an integer factor.
- :func:`pixel_norm` (``modules/pixel_norm.py``).
- :func:`contrastive_loss` (``modules/contrastive.py``).

None of them is a kernel in the JAX package, so all are plain PyTorch.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ccvs_tpu_torch.ops.resize import resize_bilinear


def _log_ive(nu, kappa):
    """log of the exponentially scaled modified Bessel ``I_nu(kappa) e^-kappa``."""
    from scipy import special

    return np.log(special.ive(nu, kappa) + 1e-300).astype(np.float32)


def _ive_ratio(nu, kappa):
    """``I_nu(kappa) / I_{nu-1}(kappa)``."""
    from scipy import special

    return (special.ive(nu, kappa) / (special.ive(nu - 1, kappa) + 1e-300)).astype(np.float32)


def _on_host(fn, nu, kappa):
    """``fn(nu, kappa)`` of scipy on a host copy of fp32 ``kappa``, back on
    its device."""
    out = fn(nu, kappa.detach().float().cpu().numpy())
    return torch.from_numpy(out).to(kappa.device)


class _LogNormConst(torch.autograd.Function):
    """``log C_m(kappa) = (m/2 - 1) log kappa - (m/2) log 2 pi - log
    I_{m/2-1}(kappa)``, fp32; forward and backward each copy ``kappa`` to
    the host and the Bessel values back."""

    @staticmethod
    def forward(ctx, kappa, m):
        nu = m / 2.0 - 1.0
        ctx.nu = nu
        ctx.save_for_backward(kappa)
        log_iv = _on_host(_log_ive, nu, kappa) + kappa  # unscale
        return nu * torch.log(kappa) - (m / 2.0) * math.log(2 * math.pi) - log_iv

    @staticmethod
    def backward(ctx, g):
        (kappa,) = ctx.saved_tensors
        return -g * _on_host(_ive_ratio, ctx.nu + 1.0, kappa), None


def nll_vMF(pred, target):
    """The vMF negative log-likelihood ``mean(-log C_m(|pred|) - pred .
    target)`` (``vmf.py:33-76``), fp32: ``pred`` ``(..., m)`` is the
    unnormalised mean direction (its norm the concentration kappa),
    ``target`` ``(..., m)`` unit vectors. kappa goes to the host and back in
    the forward and the backward pass (scipy's Bessel functions)."""
    m = pred.shape[-1]
    p = pred.float()
    kappa = torch.linalg.vector_norm(p, dim=-1)
    dot = (p * target.float()).sum(-1)
    return (-_LogNormConst.apply(kappa, float(m)) - dot).mean()


def bilinear_interpolate(x, scale=2):
    """``(B, H, W, C)`` -> ``(B, scale H, scale W, C)``, bilinear with
    half-pixel centres and the border sample repeated
    (``jax.image.resize(..., "bilinear")``)."""
    _, h, w, _ = x.shape
    return resize_bilinear(x, h * scale, w * scale)


def nearest_interpolate(x, scale=2):
    """``(B, H, W, C)`` -> ``(B, scale H, scale W, C)``, each pixel repeated
    ``scale`` x ``scale`` times."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                         mode="nearest").permute(0, 2, 3, 1)


def pixel_norm(x, eps=1e-8):
    """``x / sqrt(mean(x^2 over channels) + eps)`` (``pixel_norm.py``)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def contrastive_loss(anchor, positive, temperature=0.07):
    """InfoNCE over flattened features (``contrastive.py``): row ``i`` of
    ``anchor`` against every row of ``positive``, its own the target."""
    a = anchor.reshape(anchor.shape[0], -1)
    p = positive.reshape(positive.shape[0], -1)
    a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-8)
    p = p / (torch.linalg.vector_norm(p, dim=1, keepdim=True) + 1e-8)
    logp = torch.log_softmax(a @ p.T / temperature, dim=1)
    return -logp.diagonal().mean()
