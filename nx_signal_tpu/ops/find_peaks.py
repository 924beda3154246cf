"""scipy-style find_peaks with prominences and widths, JIT-native.

New relative to the reference (nx_signal has only comparator-based
argrel* extrema, SURVEY.md §2.7); scipy.signal.find_peaks semantics are
the contract. The fixed-shape encoding follows the reference's idiom
(peak_finding.ex:340-346): a -1-padded index vector plus a valid count,
so every output has a static shape under jit.

Design — scipy's implementation is three sequential C loops
(per-peak leftward/rightward scans); those do not vectorize. Here:

- detection: plateau-aware local maxima from sign-of-diff forward fills —
  pure elementwise + one cummax, no loop.
- prominences: for each peak the "nearest strictly-higher sample" and the
  "minimum between peak and higher point" are range queries. We build
  sparse tables (range max, and range argmin with both tie orientations)
  in O(n log n) and answer every peak's query with binary lifting in
  O(log n) gathers — all peaks in parallel.
- widths: the interpolated crossing search reuses the same skeleton with
  range-min skipping.
- distance filtering: scipy's greedy highest-peak-first suppression is
  inherently sequential in priority order; it runs as a lax.fori_loop of
  O(P) vector steps (P = peak capacity) — O(P^2) work but fully
  vectorized per step.

Memory: the sparse tables are O(n log n) (4 f32/i32 tables of n*ceil(log2
n) each when prominences are requested). For very long signals pass
`wlen` (which also bounds scipy's own scan cost) or window the signal.
"""

import math
from typing import NamedTuple

import numpy as np

import jax.numpy as jnp
from jax import lax

from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = ["find_peaks", "peak_prominences", "peak_widths", "Peaks",
           "find_peaks_cwt"]


class Peaks(NamedTuple):
    """indices: (max_peaks,) int32, -1-padded after the first
    `valid_count`; properties: dict of (max_peaks,) arrays aligned with
    indices (padding rows hold zeros).

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.find_peaks import find_peaks
    >>> pk = find_peaks(jnp.asarray([0.0, 2.0, 0.0, 3.0, 0.0]))
    >>> pk.indices, pk.valid_count   # fixed shape, -1 padded
    (Array([ 1,  3, -1], dtype=int32), Array(2, dtype=int32))
    """

    indices: jnp.ndarray
    valid_count: jnp.ndarray
    properties: dict


# ------------------------------------------------------------- detection

def _local_maxima(x):
    """Plateau-aware local maxima (scipy _local_maxima_1d semantics):
    midpoint index, left/right plateau edges. Returns per-sample arrays
    (mask, left_edge, right_edge) with edges stored at the midpoint."""
    n = x.shape[0]
    d = x[1:] - x[:-1]
    s = jnp.sign(d).astype(jnp.int32)
    idx = jnp.arange(n - 1, dtype=jnp.int32)
    nz_idx = jnp.where(s != 0, idx, jnp.int32(-1))
    last_nz = lax.cummax(nz_idx)  # last nonzero-diff index at or before i
    prev_nz = jnp.concatenate([jnp.full((1,), -1, jnp.int32), last_nz[:-1]])
    prev_sign = jnp.where(prev_nz >= 0, s[jnp.clip(prev_nz, 0)], jnp.int32(0))
    is_peak_end = (s == -1) & (prev_sign == 1)
    left_edge = prev_nz + 1
    right_edge = idx
    mid = (left_edge + right_edge) // 2
    scatter = jnp.where(is_peak_end, mid, jnp.int32(n))  # n -> dropped
    mask = jnp.zeros(n, bool).at[scatter].set(True, mode="drop")
    ledge = jnp.zeros(n, jnp.int32).at[scatter].set(left_edge, mode="drop")
    redge = jnp.zeros(n, jnp.int32).at[scatter].set(right_edge, mode="drop")
    return mask, ledge, redge


def _compact(mask, cap):
    """Front-pack the True positions into a -1-padded (cap,) index vector
    (stable order) plus the valid count."""
    n = mask.shape[0]
    order = jnp.argsort((~mask).astype(jnp.int32), stable=True)[:cap]
    count = jnp.minimum(jnp.sum(mask), cap).astype(jnp.int32)
    slots = jnp.arange(cap, dtype=jnp.int32)
    return jnp.where(slots < count, order.astype(jnp.int32), -1), count


# ------------------------------------------------- sparse range tables

def _levels(n):
    return max(1, int(math.floor(math.log2(max(n, 1)))) + 1)


def _max_tables(x):
    """tables[k][i] = max(x[i : i + 2^k]) (out-of-range -> -inf)."""
    n = x.shape[0]
    neg = jnp.array(-jnp.inf, x.dtype)
    tables = [x]
    for k in range(1, _levels(n)):
        h = 1 << (k - 1)
        prev = tables[-1]
        shifted = jnp.concatenate([prev[h:], jnp.full((h,), neg, x.dtype)])
        tables.append(jnp.maximum(prev, shifted))
    return tables


def _argmin_tables(x, prefer_larger_index):
    """(values, indices) tables: range-min with ties resolved toward the
    larger (left-scan semantics) or smaller (right-scan) index."""
    n = x.shape[0]
    pos = jnp.array(jnp.inf, x.dtype)
    vals = [x]
    idxs = [jnp.arange(n, dtype=jnp.int32)]
    for k in range(1, _levels(n)):
        h = 1 << (k - 1)
        v, i = vals[-1], idxs[-1]
        v2 = jnp.concatenate([v[h:], jnp.full((h,), pos, x.dtype)])
        i2 = jnp.concatenate([i[h:], jnp.full((h,), -1, jnp.int32)])
        if prefer_larger_index:
            take_right = v2 <= v
        else:
            take_right = v2 < v
        vals.append(jnp.where(take_right, v2, v))
        idxs.append(jnp.where(take_right, i2, i))
    return vals, idxs


def _gather(table, i):
    return table[jnp.clip(i, 0, table.shape[0] - 1)]


def _search_left(tables, p, lo, v, skip_below):
    """Largest j in [lo, p-1] with NOT skip(x-range); returns e = the
    window start in [lo, p] such that x[e-1] violates the skip predicate
    (or e == lo if the whole window satisfies it). skip_below=True skips
    blocks whose max <= v (previous-greater search); False skips blocks
    whose min > v (previous <=-crossing search, `tables` then = min)."""
    e = p
    for k in reversed(range(len(tables))):
        blk = 1 << k
        start = e - blk
        stat = _gather(tables[k], start)
        ok = start >= lo
        skip = (stat <= v) if skip_below else (stat > v)
        e = jnp.where(ok & skip, start, e)
    return e


def _search_right(tables, p, hi, v, skip_below):
    """Mirror of _search_left over [p+1, hi]: returns e in [p+1, hi+1]
    with x[e] violating the skip predicate (or e == hi+1)."""
    e = p + 1
    for k in reversed(range(len(tables))):
        blk = 1 << k
        stat = _gather(tables[k], e)
        ok = e + blk <= hi + 1
        skip = (stat <= v) if skip_below else (stat > v)
        e = jnp.where(ok & skip, e + blk, e)
    return e


def _range_argmin(vals, idxs, lo, hi, prefer_larger):
    """(min value, tie-resolved index) over inclusive [lo, hi] (lo <= hi),
    vectorized over query arrays, using the two-block overlap trick with a
    per-query level selected by masking over the static level list. The
    tie orientation must match the one the tables were built with."""
    length = hi - lo + 1
    klev = jnp.floor(jnp.log2(jnp.maximum(length, 1).astype(jnp.float32)))
    klev = klev.astype(jnp.int32)
    out_v = _gather(vals[0], lo)
    out_i = _gather(idxs[0], lo)
    for k in range(len(vals)):
        blk = 1 << k
        v1, i1 = _gather(vals[k], lo), _gather(idxs[k], lo)
        v2, i2 = _gather(vals[k], hi - blk + 1), _gather(idxs[k], hi - blk + 1)
        tie = (v2 == v1) & ((i2 > i1) if prefer_larger else (i2 < i1))
        take2 = (v2 < v1) | tie
        cv = jnp.where(take2, v2, v1)
        ci = jnp.where(take2, i2, i1)
        sel = klev == k
        out_v = jnp.where(sel, cv, out_v)
        out_i = jnp.where(sel, ci, out_i)
    return out_v, out_i


# ------------------------------------------------------------ prominences

def _wlen_half(wlen):
    if wlen is None:
        return None
    wlen = int(wlen)
    if wlen < 2:
        raise ValueError(f"wlen must be at least 2, got {wlen}")
    if wlen % 2 == 0:
        wlen += 1  # scipy rounds even wlen up to the next odd
    return (wlen - 1) // 2


def _prominence_arrays(x, peaks, valid, wlen=None):
    n = x.shape[0]
    v = _gather(x, peaks)
    half = _wlen_half(wlen)
    lo = jnp.zeros_like(peaks) if half is None else jnp.maximum(peaks - half, 0)
    hi = jnp.full_like(peaks, n - 1) if half is None else jnp.minimum(
        peaks + half, n - 1
    )
    maxt = _max_tables(x)
    lvals, lidx = _argmin_tables(x, prefer_larger_index=True)
    rvals, ridx = _argmin_tables(x, prefer_larger_index=False)

    e_l = _search_left(maxt, peaks, lo, v, skip_below=True)
    lmin, lbase = _range_argmin(lvals, lidx, e_l, peaks, prefer_larger=True)
    e_r = _search_right(maxt, peaks, hi, v, skip_below=True)
    rmin, rbase = _range_argmin(rvals, ridx, peaks, e_r - 1, prefer_larger=False)

    prom = v - jnp.maximum(lmin, rmin)
    zero = jnp.zeros((), prom.dtype)
    return (
        jnp.where(valid, prom, zero),
        jnp.where(valid, lbase, -1),
        jnp.where(valid, rbase, -1),
    )


def peak_prominences(x, peaks, *, wlen=None):
    """Prominence of each peak and its left/right bases —
    scipy.signal.peak_prominences semantics (the base on each side is the
    minimum between the peak and the nearest strictly-higher sample or the
    signal edge / wlen window edge, ties resolved toward the peak).
    `peaks` may be -1-padded (the find_peaks encoding); padded rows get
    prominence 0 and bases -1. Vectorized over peaks via sparse-table
    binary lifting (see module docstring) instead of per-peak scans.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.find_peaks import peak_prominences
    >>> x = jnp.asarray([0.0, 2.0, 0.0, 3.0, 0.0])
    >>> prom, lb, rb = peak_prominences(x, jnp.asarray([1, 3]))
    >>> np.asarray(prom), np.asarray(lb), np.asarray(rb)
    (array([2., 3.], dtype=float32), array([0, 2], dtype=int32), array([2, 4], dtype=int32))
    """
    x = jnp.asarray(x).astype(DEFAULT_FLOAT)
    if x.ndim != 1:
        raise ValueError("x must be 1-D")
    peaks = jnp.asarray(peaks).astype(jnp.int32)
    valid = peaks >= 0
    return _prominence_arrays(x, jnp.clip(peaks, 0), valid, wlen)


# ------------------------------------------------------------------ widths

def _width_arrays(x, peaks, valid, rel_height, prom, lbase, rbase):
    n = x.shape[0]
    v = _gather(x, peaks)
    height = v - prom * rel_height
    mint = _min_tables(x)

    # left crossing: largest i in [lbase, p] with x[i] <= height
    e_l = _search_left(mint, peaks, jnp.clip(lbase, 0), height, skip_below=False)
    i_l = jnp.maximum(e_l - 1, jnp.clip(lbase, 0))
    xl = _gather(x, i_l)
    xl1 = _gather(x, i_l + 1)
    interp_l = xl < height
    frac_l = jnp.where(interp_l, (height - xl) / jnp.where(xl1 == xl, 1.0, xl1 - xl), 0.0)
    left_ip = i_l.astype(height.dtype) + frac_l

    # right crossing: smallest i in [p, rbase] with x[i] <= height
    e_r = _search_right(mint, peaks, jnp.clip(rbase, 0), height, skip_below=False)
    i_r = jnp.minimum(e_r, jnp.clip(rbase, 0))
    xr = _gather(x, i_r)
    xr1 = _gather(x, i_r - 1)
    interp_r = xr < height
    frac_r = jnp.where(interp_r, (height - xr) / jnp.where(xr1 == xr, 1.0, xr1 - xr), 0.0)
    right_ip = i_r.astype(height.dtype) - frac_r

    widths = right_ip - left_ip
    zero = jnp.zeros((), widths.dtype)
    return (
        jnp.where(valid, widths, zero),
        jnp.where(valid, height, zero),
        jnp.where(valid, left_ip, zero),
        jnp.where(valid, right_ip, zero),
    )


def _min_tables(x):
    n = x.shape[0]
    pos = jnp.array(jnp.inf, x.dtype)
    tables = [x]
    for k in range(1, _levels(n)):
        h = 1 << (k - 1)
        prev = tables[-1]
        shifted = jnp.concatenate([prev[h:], jnp.full((h,), pos, x.dtype)])
        tables.append(jnp.minimum(prev, shifted))
    return tables


def peak_widths(x, peaks, *, rel_height=0.5, wlen=None):
    """Width of each peak at `rel_height` of its prominence —
    scipy.signal.peak_widths semantics (linear-interpolated crossings of
    height = peak_height - prominence*rel_height, bounded by the
    prominence bases). Returns (widths, width_heights, left_ips,
    right_ips); -1-padded peaks give zero rows.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.find_peaks import peak_widths
    >>> x = jnp.asarray([0.0, 1.0, 2.0, 1.0, 0.0])
    >>> widths, heights, lips, rips = peak_widths(x, jnp.asarray([2]))
    >>> np.asarray(widths), np.asarray(heights)
    (array([2.], dtype=float32), array([1.], dtype=float32))
    """
    if rel_height < 0:
        raise ValueError("rel_height must be greater or equal to 0")
    x = jnp.asarray(x).astype(DEFAULT_FLOAT)
    if x.ndim != 1:
        raise ValueError("x must be 1-D")
    peaks = jnp.asarray(peaks).astype(jnp.int32)
    valid = peaks >= 0
    p = jnp.clip(peaks, 0)
    prom, lbase, rbase = _prominence_arrays(x, p, valid, wlen)
    return _width_arrays(x, p, valid, rel_height, prom, lbase, rbase)


# ---------------------------------------------------------------- filters

def _unpack_interval(value, peaks, x_len, name):
    """scipy _unpack_condition_args: scalar / array / (min, max) pair."""
    def at_peaks(v):
        if v is None:
            return None
        v = jnp.asarray(v)
        if v.ndim == 0:
            return v
        if v.shape[0] != x_len:
            raise ValueError(
                f"array {name} must have the same length as x"
            )
        return _gather(v, peaks)

    if isinstance(value, (tuple, list)):
        if len(value) != 2:
            raise ValueError(f"{name} must be a number, array, or (min, max)")
        return at_peaks(value[0]), at_peaks(value[1])
    return at_peaks(value), None


def _distance_filter(positions, heights, valid, distance, cap):
    """scipy's greedy suppression: process peaks from highest to lowest;
    a surviving peak removes every other peak closer than `distance`.

    Tie note: among EQUAL-height peaks the processing order (and hence the
    surviving set) follows this argsort's tie order; scipy's follows
    numpy's unstable quicksort, so tied results can differ — both are
    valid greedy outcomes, and untied data matches scipy exactly."""
    priority = jnp.argsort(jnp.where(valid, heights, -jnp.inf))  # ascending
    pos_f = positions.astype(jnp.float32)

    def body(t, keep):
        j = priority[cap - 1 - t]
        alive = keep[j] & valid[j]
        near = jnp.abs(pos_f - pos_f[j]) < distance
        near = near & (jnp.arange(cap) != j) & valid
        return jnp.where(alive, keep & ~near, keep)

    keep = lax.fori_loop(0, cap, body, jnp.ones(cap, bool))
    return keep & valid


def find_peaks(x, *, height=None, threshold=None, distance=None,
               prominence=None, width=None, wlen=None, rel_height=0.5,
               plateau_size=None, max_peaks=None):
    """Find local maxima subject to property conditions —
    scipy.signal.find_peaks semantics (same condition order: plateau_size,
    height, threshold, distance, prominence, width; each may be a scalar,
    a length-of-x array, or a (min, max) pair with None for open ends).

    Returns `Peaks(indices, valid_count, properties)` with static shapes:
    indices is (max_peaks,) -1-padded (default capacity (n+1)//2, the
    theoretical maximum — pass `max_peaks` to bound memory; with a smaller
    capacity the left-most peaks are kept and the rest dropped). Properties
    hold the scipy keys for whichever conditions were requested.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.find_peaks import find_peaks
    >>> p = find_peaks(jnp.asarray([0.0, 2.0, 0.0, 3.0, 0.0, 1.0, 0.0]), height=1.5)
    >>> p.indices
    Array([ 1,  3, -1, -1], dtype=int32)
    >>> p.valid_count
    Array(2, dtype=int32)
    >>> p.properties["peak_heights"]
    Array([2., 3., 0., 0.], dtype=float32)
    """
    x = jnp.asarray(x).astype(DEFAULT_FLOAT)
    if x.ndim != 1:
        raise ValueError("x must be 1-D")
    n = x.shape[0]
    cap = (n + 1) // 2 if max_peaks is None else int(max_peaks)
    if cap < 1:
        raise ValueError("max_peaks must be positive")
    if distance is not None and distance < 1:
        raise ValueError("distance must be greater or equal to 1")

    mask, ledges, redges = _local_maxima(x)
    peaks, _ = _compact(mask, cap)
    valid = peaks >= 0
    p = jnp.clip(peaks, 0)
    props = {}

    if plateau_size is not None:
        le, re = _gather(ledges, p), _gather(redges, p)
        sizes = (re - le + 1).astype(jnp.int32)
        pmin, pmax = _unpack_interval(plateau_size, p, n, "plateau_size")
        if pmin is not None:
            valid &= sizes >= pmin
        if pmax is not None:
            valid &= sizes <= pmax
        props["plateau_sizes"] = jnp.where(valid, sizes, 0)
        props["left_edges"] = jnp.where(valid, le, -1)
        props["right_edges"] = jnp.where(valid, re, -1)

    heights_at = _gather(x, p)
    if height is not None:
        hmin, hmax = _unpack_interval(height, p, n, "height")
        if hmin is not None:
            valid &= heights_at >= hmin
        if hmax is not None:
            valid &= heights_at <= hmax
        props["peak_heights"] = jnp.where(valid, heights_at, 0.0)

    if threshold is not None:
        tmin, tmax = _unpack_interval(threshold, p, n, "threshold")
        left_t = heights_at - _gather(x, jnp.maximum(p - 1, 0))
        right_t = heights_at - _gather(x, jnp.minimum(p + 1, n - 1))
        both_min = jnp.minimum(left_t, right_t)
        both_max = jnp.maximum(left_t, right_t)
        if tmin is not None:
            valid &= both_min > tmin
        if tmax is not None:
            valid &= both_max < tmax
        props["left_thresholds"] = jnp.where(valid, left_t, 0.0)
        props["right_thresholds"] = jnp.where(valid, right_t, 0.0)

    if distance is not None:
        valid = _distance_filter(p, heights_at, valid, float(distance), cap)

    need_prom = prominence is not None or width is not None
    if need_prom:
        prom, lbase, rbase = _prominence_arrays(x, p, valid, wlen)
        if prominence is not None:
            pmin, pmax = _unpack_interval(prominence, p, n, "prominence")
            if pmin is not None:
                valid &= prom >= pmin
            if pmax is not None:
                valid &= prom <= pmax
        props["prominences"] = jnp.where(valid, prom, 0.0)
        props["left_bases"] = jnp.where(valid, lbase, -1)
        props["right_bases"] = jnp.where(valid, rbase, -1)

    if width is not None:
        widths, wh, lip, rip = _width_arrays(
            x, p, valid, rel_height, props["prominences"],
            props["left_bases"], props["right_bases"]
        )
        wmin, wmax = _unpack_interval(width, p, n, "width")
        if wmin is not None:
            valid &= widths >= wmin
        if wmax is not None:
            valid &= widths <= wmax
        props["widths"] = jnp.where(valid, widths, 0.0)
        props["width_heights"] = jnp.where(valid, wh, 0.0)
        props["left_ips"] = jnp.where(valid, lip, 0.0)
        props["right_ips"] = jnp.where(valid, rip, 0.0)

    # final compaction: surviving peaks front-packed, properties aligned
    order = jnp.argsort(~valid, stable=True)
    count = jnp.sum(valid).astype(jnp.int32)
    slots = jnp.arange(cap, dtype=jnp.int32)
    out_idx = jnp.where(slots < count, jnp.take(peaks, order), -1)
    out_props = {
        k: jnp.where(slots < count, jnp.take(a, order),
                     jnp.zeros((), a.dtype) - (1 if a.dtype == jnp.int32 else 0))
        for k, a in props.items()
    }
    return Peaks(indices=out_idx, valid_count=count, properties=out_props)


# ------------------------------------------------------- find_peaks_cwt

def _row_relmax(matr):
    """Strict interior local maxima per row, order=1, clip-mode edges
    (boundary samples compare against themselves, so they never qualify)
    — scipy _boolrelextrema(axis=1, order=1) semantics, host numpy."""
    out = np.zeros(matr.shape, dtype=bool)
    out[:, 1:-1] = (matr[:, 1:-1] > matr[:, :-2]) & \
                   (matr[:, 1:-1] > matr[:, 2:])
    return out


def _identify_ridge_lines(matr, max_distances, gap_thresh):
    """Connect per-row local maxima into ridge lines down the scale axis
    (Du et al. 2006 ridge tracing, scipy.signal semantics): start at the
    largest width that has any maxima; walking toward smaller widths, each
    maximum claims the nearest live line whose tail column (as of row
    entry) is within max_distances[row], else it seeds a new line; a line
    idle for more than gap_thresh consecutive rows is closed. Returns
    [rows, cols] array pairs per line, placed in ascending-row order.

    Layout here is structure-of-arrays: per-line point traces plus
    parallel `tail`/`idle` vectors, with the row's claims resolved in one
    vectorized candidate-by-line distance matrix rather than a per-column
    scan."""
    relmax = _row_relmax(matr)
    rows_with_max = np.nonzero(relmax.any(axis=1))[0]
    if rows_with_max.size == 0:
        return []
    top = int(rows_with_max[-1])

    seed_cols = np.nonzero(relmax[top])[0]
    trace = [[(top, int(c))] for c in seed_cols]  # per-line (row, col) trail
    tail = seed_cols.astype(np.int64)  # column each line last claimed
    idle = np.zeros(tail.size, dtype=np.int64)  # rows since that claim
    closed = []

    for row in range(top - 1, -1, -1):
        idle += 1
        cand = np.nonzero(relmax[row])[0]
        if tail.size and cand.size:
            # all of this row's assignments in one shot, against the tails
            # as they stood at row entry (claims don't shift the targets
            # of later candidates in the same row)
            dist = np.abs(cand[:, None] - tail[None, :])
            owner = dist.argmin(axis=1)
            claimed = dist[np.arange(cand.size), owner] <= max_distances[row]
        else:
            owner = np.zeros(cand.size, dtype=np.intp)
            claimed = np.zeros(cand.size, dtype=bool)

        for c, o, ok in zip(cand, owner, claimed):
            if ok:
                trace[o].append((row, int(c)))
                idle[o] = 0
                tail[o] = c  # visible from the next row on
            else:
                trace.append([(row, int(c))])
        born = cand[~claimed]
        if born.size:
            tail = np.concatenate([tail, born.astype(np.int64)])
            idle = np.concatenate([idle, np.zeros(born.size, np.int64)])

        expired = idle > gap_thresh
        if expired.any():
            closed.extend(trace[i] for i in np.nonzero(expired)[0])
            trace = [t for t, dead in zip(trace, expired) if not dead]
            tail, idle = tail[~expired], idle[~expired]

    out_lines = []
    for t in closed + trace:
        r = np.asarray([p[0] for p in t])
        c = np.asarray([p[1] for p in t])
        # place point i at its ascending-row argsort rank (a plain
        # reversal for the usual strictly-descending trail; when a line
        # claimed two maxima of one row, this scatter placement — not a
        # gather — is what scipy's output exhibits, so keep it)
        dst = np.argsort(r)
        rows_out = np.empty(r.size, dtype=r.dtype)
        cols_out = np.empty(c.size, dtype=c.dtype)
        rows_out[dst] = r
        cols_out[dst] = c
        out_lines.append([rows_out, cols_out])
    return out_lines


def _filter_ridge_lines(cwt_mat, ridge_lines, window_size, min_length,
                        min_snr, noise_perc):
    """Keep ridge lines long enough (>= min_length rows) and with
    smallest-scale SNR >= min_snr, where the local noise floor is the
    noise_perc'th percentile of |cwt row 0| over a window_size
    neighborhood — scipy _filter_ridge_lines semantics."""
    n_points = cwt_mat.shape[1]
    if min_length is None:
        min_length = math.ceil(cwt_mat.shape[0] / 4.0)
    if window_size is None:
        window_size = math.ceil(n_points / 20.0)
    window_size = int(window_size)
    hf_window, odd = divmod(window_size, 2)
    row_one = cwt_mat[0, :]
    # noise floor = noise_perc'th percentile of the RAW (not absolute)
    # smallest-scale coefficients in the window — scipy's definition
    noises = np.array([
        np.percentile(row_one[max(ind - hf_window, 0):
                              min(ind + hf_window + odd, n_points)],
                      noise_perc)
        for ind in range(n_points)])

    def keep(line):
        if len(line[0]) < min_length:
            return False
        with np.errstate(divide="ignore"):
            snr = abs(cwt_mat[line[0][0], line[1][0]] / noises[line[1][0]])
        return snr >= min_snr

    return [line for line in ridge_lines if keep(line)]


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None,
                   gap_thresh=None, min_length=None, min_snr: float = 1,
                   noise_perc: float = 10, window_size=None):
    """Wavelet-based peak finding — scipy.signal.find_peaks_cwt
    semantics: take the continuous wavelet transform over `widths`
    (default wavelet: ricker), trace ridge lines across scales, and keep
    ridges that are long and loud enough; returns the sorted column
    indices where surviving ridges reach the smallest scale.

    Runs host-side in f64 (ridge tracing is sequential bookkeeping over
    comparisons that must not flip on f32 rounding — the same f64-pocket
    rule as the design math); use `cwt` directly for on-device transforms.
    Not in the reference.

    Examples:

    Peaks of a period-20 sine found by wavelet ridge lines:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.find_peaks import find_peaks_cwt
    >>> x = jnp.sin(2 * jnp.pi * jnp.arange(100) / 20.0)
    >>> np.asarray(find_peaks_cwt(x, jnp.arange(3, 10)))
    array([ 6, 25, 45, 65, 86])
    """
    from nx_signal_tpu.ops.wavelets import _cwt_f64, _ricker_np

    widths = np.atleast_1d(np.asarray(widths, dtype=np.float64))
    if widths.size == 0:
        raise ValueError("widths must be nonempty")
    if gap_thresh is None:
        gap_thresh = np.ceil(widths[0])
    if max_distances is None:
        max_distances = widths / 4.0
    max_distances = np.atleast_1d(np.asarray(max_distances))
    if max_distances.shape[0] < widths.shape[0]:
        raise ValueError("max_distances must have at least as many entries "
                         "as widths")
    if wavelet is None:
        wavelet = _ricker_np
    cwt_mat = _cwt_f64(vector, wavelet, widths)
    ridge_lines = _identify_ridge_lines(cwt_mat, max_distances, gap_thresh)
    filtered = _filter_ridge_lines(cwt_mat, ridge_lines, window_size,
                                   min_length, min_snr, noise_perc)
    max_locs = np.asarray(sorted(line[1][0] for line in filtered),
                          dtype=np.int64)
    return max_locs
