"""The arithmetic of the per-layer readers (``metrics/<name>.py``): each
takes the run's readings (spans, the device trace, the work of the traced
slice from ``counts/``) and returns its value, or None where there is
nothing to read."""

import statistics

from ccvs_bench.counts import kernels

K1 = ("vq_split_kernel", "vq_mma_kernel", "vq_merge_kernel")
K2 = ("flash_decode_kernel",)


def _trace(r):
    t = r["trace"]
    return t if t is not None and t.kernels else None


def span_ms(r, name):
    """The median of the window's calls of span ``name``, over the steps of
    a call where the readings count them (``per_call``)."""
    calls = r["spans_ms"].get(name)
    if not calls:
        return None
    return statistics.median(calls) / r.get("per_call", {}).get(name, 1)


def idle_share(r):
    """The share of the traced wall time in which no device operation ran, %."""
    t = _trace(r)
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(r):
    """Model FLOPs of the traced work over the traced wall time at the bf16 peak, %."""
    t = _trace(r)
    return None if t is None else 100.0 * r["flops"] / (t.window_s * kernels.PEAK_BF16)


def k1_roofline(r):
    """K1's least time (the algorithm's FLOPs at the TF32 peak, or its bytes)
    for every traced search, over the traced time of its kernels, %."""
    t = _trace(r)
    if t is None:
        return None
    sec, _ = t.matching(*K1)
    searches = t.matching("vq_mma_kernel")[1]
    if not searches:
        return None
    flops, n_bytes = r["k1"]
    return 100.0 * searches * kernels.bound_s(flops, n_bytes, kernels.PEAK_TF32) / sec


def k2_roofline(r):
    """K2's bytes at every traced launch's position, at the HBM peak, over
    its traced time, %; nothing where the launches are not those the
    traffic's positions give."""
    t = _trace(r)
    if t is None:
        return None
    sec, n = t.matching(*K2)
    if n != r["k2_launches"]:
        return None
    return 100.0 * r["k2_bytes"] / kernels.PEAK_HBM / sec
