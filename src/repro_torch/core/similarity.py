"""Statistical similarity analysis of decomposed weights (paper Sec. 3.2.2);
the port's own copy of ``repro/core/similarity.py`` (numpy only, the same
functions and arithmetic, so results are equal).

Implements (pure numpy, no scipy):
  * Wilcoxon rank-sum test with tie correction        (paper Table 4)
  * Pearson / Spearman / Kendall tau-b correlations   (paper Table 5)
  * 95% confidence interval of |w_hat - w_hat_high|   (paper Fig. 4)

Kendall's tau-b is computed exactly in O(n log n) via merge-sort inversion
counting (Knight's algorithm), so the full 1-D weight vectors of real
models remain tractable.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Wilcoxon rank-sum (Mann-Whitney) with normal approximation + tie correction
# ---------------------------------------------------------------------------
def rank_sum_test(x: np.ndarray, y: np.ndarray) -> Dict[str, float]:
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    n1, n2 = len(x), len(y)
    both = np.concatenate([x, y])
    order = np.argsort(both, kind="mergesort")
    ranks = np.empty(len(both), np.float64)
    ranks[order] = np.arange(1, len(both) + 1)
    # average ranks for ties
    sorted_vals = both[order]
    i = 0
    tie_term = 0.0
    while i < len(sorted_vals):
        j = i
        while j + 1 < len(sorted_vals) and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        if j > i:
            t = j - i + 1
            avg = 0.5 * (i + 1 + j + 1)
            ranks[order[i:j + 1]] = avg
            tie_term += t ** 3 - t
        i = j + 1
    R1 = ranks[:n1].sum()
    U1 = R1 - n1 * (n1 + 1) / 2.0
    mu = n1 * n2 / 2.0
    n = n1 + n2
    sigma2 = n1 * n2 / 12.0 * ((n + 1) - tie_term / (n * (n - 1)))
    sigma = math.sqrt(max(sigma2, 1e-300))
    z = (U1 - mu) / sigma
    p = math.erfc(abs(z) / math.sqrt(2.0))  # two-sided
    return {"z": z, "p": p, "U": U1}


# ---------------------------------------------------------------------------
# Correlations
# ---------------------------------------------------------------------------
def pearson(x: np.ndarray, y: np.ndarray) -> float:
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    xc, yc = x - x.mean(), y - y.mean()
    denom = math.sqrt(float((xc * xc).sum()) * float((yc * yc).sum()))
    return float((xc * yc).sum() / denom) if denom else 0.0


def quality_report(ref: np.ndarray, y: np.ndarray) -> Dict[str, float]:
    """The two calibration-quality coordinates the recipe search and the
    nesting-quality bench score rungs on (DESIGN.md Sec. 13):

      * ``sqnr_db`` - signal-to-quantization-noise ratio of ``y`` against
        the reference, ``10*log10(||ref||^2 / ||ref - y||^2)`` (capped at
        300 dB for the exact-match case);
      * ``pearson`` - Pearson correlation of the flattened outputs
        (paper Table 5's linearity measure, applied to activations).
    """
    ref = np.asarray(ref, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    sig = float((ref * ref).sum())
    noise = float(((ref - y) ** 2).sum())
    if noise <= 0.0 or sig <= 0.0:
        db = 300.0
    else:
        db = min(10.0 * math.log10(sig / noise), 300.0)
    return {"sqnr_db": db, "pearson": pearson(ref, y)}


def _ranks(a: np.ndarray) -> np.ndarray:
    order = np.argsort(a, kind="mergesort")
    ranks = np.empty(len(a), np.float64)
    ranks[order] = np.arange(1, len(a) + 1)
    sv = a[order]
    i = 0
    while i < len(sv):
        j = i
        while j + 1 < len(sv) and sv[j + 1] == sv[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    return ranks


def spearman(x: np.ndarray, y: np.ndarray) -> float:
    return pearson(_ranks(np.asarray(x).ravel()), _ranks(np.asarray(y).ravel()))


def _merge_count(a: np.ndarray) -> int:
    """Count inversions via merge sort (iterative bottom-up, int64-safe)."""
    a = a.copy()
    n = len(a)
    buf = np.empty_like(a)
    inv = 0
    width = 1
    while width < n:
        for lo in range(0, n, 2 * width):
            mid = min(lo + width, n)
            hi = min(lo + 2 * width, n)
            i, j, k = lo, mid, lo
            while i < mid and j < hi:
                if a[i] <= a[j]:
                    buf[k] = a[i]; i += 1
                else:
                    buf[k] = a[j]; j += 1
                    inv += mid - i
                k += 1
            while i < mid:
                buf[k] = a[i]; i += 1; k += 1
            while j < hi:
                buf[k] = a[j]; j += 1; k += 1
        a, buf = buf, a
        width *= 2
    return inv


def _tie_pairs(a: np.ndarray) -> int:
    _, counts = np.unique(a, return_counts=True)
    return int((counts * (counts - 1) // 2).sum())


def kendall(x: np.ndarray, y: np.ndarray, max_n: int = 200_000,
            seed: int = 0) -> float:
    """Kendall tau-b; subsamples above max_n for tractability."""
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    n = len(x)
    if n > max_n:
        idx = np.random.default_rng(seed).choice(n, max_n, replace=False)
        x, y = x[idx], y[idx]
        n = max_n
    order = np.lexsort((y, x))
    ys = y[order]
    n0 = n * (n - 1) // 2
    n1 = _tie_pairs(x)
    n2 = _tie_pairs(y)
    n3 = 0  # joint-tie pairs
    xs = x[order]
    i = 0
    swaps_excl = 0
    # discordant pairs = inversions in y after sorting by x, excluding x-ties
    # handled via counting inversions within x-tie groups and subtracting.
    inv_total = _merge_count(ys)
    while i < n:
        j = i
        while j + 1 < n and xs[j + 1] == xs[i]:
            j += 1
        if j > i:
            grp = ys[i:j + 1]
            swaps_excl += _merge_count(grp)
            n3 += _tie_pairs(grp)
        i = j + 1
    discordant = inv_total - swaps_excl
    concordant_minus = n0 - n1 - n2 + n3 - 2 * discordant
    denom = math.sqrt(float(n0 - n1)) * math.sqrt(float(n0 - n2))
    return float(concordant_minus / denom) if denom else 0.0


# ---------------------------------------------------------------------------
# Confidence interval of |delta| (paper Fig. 4)
# ---------------------------------------------------------------------------
def abs_delta_ci(a: np.ndarray, b: np.ndarray, q: float = 0.95) -> Dict[str, float]:
    d = np.abs(np.asarray(a, np.float64).ravel() - np.asarray(b, np.float64).ravel())
    lo = float(np.quantile(d, (1 - q) / 2))
    hi = float(np.quantile(d, 1 - (1 - q) / 2))
    return {"lb": lo, "ub": hi, "mean": float(d.mean()), "max": float(d.max())}
