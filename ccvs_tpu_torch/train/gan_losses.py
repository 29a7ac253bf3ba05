"""GAN losses (counterpart of ``ccvs_tpu/train/gan_losses.py``): logistic,
hinge, original and WGAN, over score tensors, in fp32; the gradient penalties
take the discriminator's apply function.

The penalties differentiate twice: :func:`r1_penalty` takes the gradient of
the scores with respect to the real input with ``create_graph=True``, so
that the penalty's own gradient reaches the discriminator's parameters (the
JAX package's ``jax.grad`` inside ``jax.grad``). Every operation of the
discriminators has a double backward in PyTorch; an augmentation inside them
(``F.grid_sample``) would not.
"""

import torch
import torch.nn.functional as F


def softplus(x):
    return F.softplus(x.float())


# logistic (every shipped configuration's)

def g_logistic(fake_score):
    return softplus(-fake_score).mean()


def d_logistic(real_score, fake_score):
    return softplus(-real_score).mean() + softplus(fake_score).mean()


def d_logistic_fake_only(fake_score):
    return softplus(fake_score).mean()


def d_logistic_real_only(real_score):
    return softplus(-real_score).mean()


def g_logistic_real(real_score):
    """The generator pushing real-domain scores towards "fake" (the feature
    discriminator's video side)."""
    return softplus(real_score).mean()


# hinge

def g_hinge(fake_score):
    return -fake_score.float().mean()


def d_hinge(real_score, fake_score):
    return (torch.relu(1.0 - real_score.float()).mean()
            + torch.relu(1.0 + fake_score.float()).mean()) / 2.0


# original (BCE)

def g_original(fake_score):
    return softplus(-fake_score).mean()


def d_original(real_score, fake_score):
    return (softplus(-real_score).mean() + softplus(fake_score).mean()) / 2.0


# improved WGAN

def g_wgan(fake_score):
    return -fake_score.float().mean()


def d_wgan(real_score, fake_score, gp):
    return fake_score.float().mean() - real_score.float().mean() + 10.0 * gp


def _input_grad(d_apply, x):
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(d_apply(x).sum(), x, create_graph=True)
    return g.reshape(g.shape[0], -1).float()


def wgan_gradient_penalty(d_apply, x_real, x_fake, generator=None):
    """``mean((||grad D(interp)|| - 1)^2)`` on interpolates with one uniform
    weight an item, drawn from ``generator``."""
    b = x_real.shape[0]
    alpha = torch.rand((b,) + (1,) * (x_real.ndim - 1), generator=generator,
                       device=x_real.device)
    interp = alpha * x_real.detach() + (1 - alpha) * x_fake.detach()
    g = _input_grad(d_apply, interp)
    return ((torch.linalg.vector_norm(g, dim=1) - 1.0) ** 2).mean()


def r1_penalty(d_apply, x_real):
    """R1: ``mean over items of ||grad_x sum D(x)||^2`` at the real input."""
    return (_input_grad(d_apply, x_real) ** 2).sum(1).mean()


GENERATOR_LOSSES = {"logistic": g_logistic, "hinge": g_hinge, "original": g_original,
                    "wgan": g_wgan}
DISCRIMINATOR_LOSSES = {"logistic": d_logistic, "hinge": d_hinge, "original": d_original}
