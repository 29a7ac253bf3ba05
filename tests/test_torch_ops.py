"""ccvs_tpu_torch ops against ccvs_tpu's, on the CPU, in fp32.

Inputs come from a numpy seed and go through both packages. The kernels'
plain versions are held against the Pallas kernels in interpret mode; the
kernels themselves are tested in ``test_torch_kernels.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu import ops as jops
from ccvs_tpu.ops.attention_pallas import flash_decode_attention as j_flash_decode
from ccvs_tpu.ops.vq import vq_lookup as j_vq_lookup
from ccvs_tpu.ops.vq_pallas import vq_indices_pallas
from ccvs_tpu_torch.ops import convops, correlation, fused_act, upfirdn2d, warp
from ccvs_tpu_torch.ops.attention import flash_decode_attention, flash_decode_plain
from ccvs_tpu_torch.ops.vq import vq_embed, vq_indices, vq_indices_plain, vq_lookup, vq_lookup_auto

jup = importlib.import_module("ccvs_tpu.ops.upfirdn2d")  # the package re-exports a function of that name

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# fp32 on both sides; the sums run in different orders
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("stride,padding,groups", [(1, 1, 1), (2, 0, 1), (1, 1, 2)])
def test_conv2d(rng, stride, padding, groups):
    x = rng.randn(2, 9, 9, 4).astype(np.float32)
    w = rng.randn(6, 4 // groups, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                       padding=padding, groups=groups)
    got = convops.conv2d(_t(x), _t(w), _t(b), stride=stride, padding=padding, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stride,padding,groups", [(2, 0, 1), (2, 1, 2)])
def test_conv_transpose2d(rng, stride, padding, groups):
    x = rng.randn(2, 5, 5, 4).astype(np.float32)
    w = rng.randn(4, 6 // groups, 4, 4).astype(np.float32)
    want = jops.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), None, stride=stride,
                                 padding=padding, groups=groups)
    got = convops.conv_transpose2d(_t(x), _t(w), None, stride=stride, padding=padding,
                                   groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_upfirdn2d_family(rng):
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    jk = jup.make_resample_kernel((1, 3, 3, 1))
    tk = upfirdn2d.make_resample_kernel((1, 3, 3, 1))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=0)
    cases = [
        (jup.upfirdn2d(jnp.asarray(x), jk, up=2, down=1, pad=(2, 1)),
         upfirdn2d.upfirdn2d(_t(x), tk, up=2, down=1, pad=(2, 1))),
        (jup.upfirdn2d(jnp.asarray(x), jk, up=1, down=2, pad=(1, 1)),
         upfirdn2d.upfirdn2d(_t(x), tk, up=1, down=2, pad=(1, 1))),
        (jup.upfirdn2d(jnp.asarray(x), jk, pad=(1, 0, 2, -1)),
         upfirdn2d.upfirdn2d(_t(x), tk, pad=(1, 0, 2, -1))),
        (jup.blur(jnp.asarray(x), jk, pad=(2, 1)), upfirdn2d.blur(_t(x), tk, pad=(2, 1))),
        (jup.upsample2x(jnp.asarray(x), jk), upfirdn2d.upsample2x(_t(x), tk)),
        (jup.downsample2x(jnp.asarray(x), jk), upfirdn2d.downsample2x(_t(x), tk)),
    ]
    for want, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_act(rng):
    x = rng.randn(2, 4, 4, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    np.testing.assert_allclose(fused_act.leaky_relu(_t(x), 0.1).numpy(),
                               np.asarray(jops.leaky_relu(jnp.asarray(x), 0.1)), **TOL)
    np.testing.assert_allclose(fused_act.fused_leaky_relu(_t(x), _t(b)).numpy(),
                               np.asarray(jops.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b))),
                               **TOL)


@pytest.mark.parametrize("channels", [3, 12])
def test_backwarp_out_of_range_flow(rng, channels):
    """Flows up to 3x the image size: most samples fall partly or wholly
    outside and read zeros (the JAX package takes another route for C < 8)."""
    x = rng.randn(2, 10, 12, channels).astype(np.float32)
    flow = (rng.randn(2, 10, 12, 2) * 12).astype(np.float32)
    want = jops.backwarp(jnp.asarray(x), jnp.asarray(flow))
    got = warp.backwarp(_t(x), _t(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want_s = jops.backwarp_sampled(jnp.asarray(x), jnp.asarray(flow), 2)
    got_s = warp.backwarp_sampled(_t(x), _t(flow), 2)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(warp.make_backwarp_grid(10, 12).numpy(),
                               np.asarray(jops.make_backwarp_grid(10, 12)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("stride,hw", [(1, (8, 8)), (2, (9, 10))])
def test_local_correlation(rng, stride, hw):
    a = rng.randn(2, *hw, 6).astype(np.float32)
    b = rng.randn(2, *hw, 6).astype(np.float32)
    want = jops.local_correlation(jnp.asarray(a), jnp.asarray(b), stride=stride)
    got = correlation.local_correlation(_t(a), _t(b), stride=stride)
    assert got.shape == (2, -(-hw[0] // stride), -(-hw[1] // stride), 49)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _vq_case(rng, n, k, d, tie):
    z = rng.randn(n, d).astype(np.float32)
    cb = rng.randn(k, d).astype(np.float32)
    if tie:
        # an exact tie: codes 700 and 300 are the same vector, and row 5 sits
        # on it; the smaller index must win
        cb[700] = cb[300]
        z[5] = cb[300]
    return z, cb


@pytest.mark.parametrize("n,tie", [(98, False), (77, True)])
def test_vq_indices_plain_matches_pallas(rng, n, tie):
    z, cb = _vq_case(rng, n, 1024, 32, tie)
    want = np.asarray(vq_indices_pallas(jnp.asarray(z), jnp.asarray(cb), interpret=True))
    got = vq_indices_plain(_t(z), _t(cb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(vq_indices(_t(z), _t(cb)).numpy(), want)  # CPU: plain
    if tie:
        assert got[5] == 300
    zq_j, idx_j = j_vq_lookup(jnp.asarray(z.reshape(7, n // 7, 32)), jnp.asarray(cb))
    for fn in (vq_lookup, vq_lookup_auto):
        zq, idx = fn(_t(z.reshape(7, n // 7, 32)), _t(cb))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        np.testing.assert_allclose(zq.numpy(), np.asarray(zq_j), rtol=0, atol=0)


def test_vq_embed_mult(rng):
    cb = rng.randn(8, 4).astype(np.float32)
    idx = rng.randint(0, 8, size=(2, 6))
    for mult in (1, 2):
        want = jops.vq_embed(jnp.asarray(idx), jnp.asarray(cb), mult=mult)
        got = vq_embed(torch.from_numpy(idx), _t(cb), mult=mult)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flash_decode_plain_matches_pallas(rng):
    b, nh, length, hd = 2, 4, 128, 64
    q = rng.randn(b, nh, hd).astype(np.float32)
    k = rng.randn(b, nh, length, hd).astype(np.float32)
    v = rng.randn(b, nh, length, hd).astype(np.float32)
    for pos in (0, 57, length - 1):
        want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                              interpret=True)
        got = flash_decode_plain(_t(q), _t(k), _t(v), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(flash_decode_attention(_t(q), _t(k), _t(v), pos).numpy(),
                                      got.numpy())
