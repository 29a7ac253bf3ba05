"""The work of the program's hand-written kernels and the peaks it is held
to, from shapes alone.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
A run prints the card's own power limit beside them.
"""

PEAK_BF16 = 989e12   # FLOP/s on the tensor cores: the model FLOPs of mfu
PEAK_TF32 = 495e12   # FLOP/s: K1's fp32-faithful nearest-code search
PEAK_HBM = 3.35e12   # bytes/s


def k1_work(n, k, d):
    """K1, the nearest code of ``n`` fp32 latents of depth ``d`` among ``k``
    codes: the algorithm's ``2 n k d`` FLOPs (once, however many products
    an implementation splits them into) and its bytes, each input read once
    and the indices written once."""
    return 2 * n * k * d, 4 * (n * d + k * d + n)


def k2_bytes(b, n_head, head_dim, pos, elem=2):
    """K2, single-token cached attention of ``b`` rows at position ``pos``:
    the keys and values of positions ``0..pos`` read once, the query read and
    the output written once."""
    return elem * b * n_head * head_dim * (2 * (pos + 1) + 2)


def bound_s(flops, n_bytes, peak_flops):
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, n_bytes / PEAK_HBM)
