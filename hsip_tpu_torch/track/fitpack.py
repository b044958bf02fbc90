"""Curve-fitting smoothing spline: a numpy port of FITPACK's ``curfit``.

The reference's spline predictor is ``scipy.interpolate.UnivariateSpline``
(``scripts/process_videos.py:287-315``), which wraps Dierckx's FITPACK
``curfit``/``fpcurf`` routines. The runtime here is numpy+jax (scipy is a
test-only dependency), so this module ports the algorithm itself — the
adaptive knot placement (part 1) and the rational-interpolation search for
the smoothing parameter ``p`` with ``f(p) = s`` (part 2) — so that knot
vectors and coefficients match scipy's to floating-point accuracy.

Port of the published FITPACK algorithm (P. Dierckx, "Curve and Surface
Fitting with Splines", and the netlib FITPACK sources: fpcurf, fpbspl,
fpgivs, fprota, fpback, fpdisc, fpknot, fprati), restructured for numpy.
Everything runs in float64 on host; this is the plot-only predictor path,
never the tracking hot loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["curfit", "splev", "FitpackError"]

_TOL = 1e-3  # FITPACK's relative tolerance for the root of f(p) = s
_MAXIT = 20
_CON1 = 0.1
_CON9 = 0.9
_CON4 = 0.04
_TRACE = False  # debug: print part-1 iteration state


class FitpackError(ValueError):
    """Invalid input to curfit (mirrors FITPACK's ier=10 rejections)."""


def _fpbspl(t: np.ndarray, k: int, x: float, l: int) -> np.ndarray:
    """The (k+1) b-splines of degree k non-zero at x, t[l] <= x < t[l+1].

    ``l`` is a 0-based index into ``t``. Stable Cox–de Boor recurrence;
    valid for x outside [t[l], t[l+1]] too (polynomial extension), which is
    what splev's ext=0 extrapolation relies on.
    """
    h = np.zeros(k + 1)
    h[0] = 1.0
    for j in range(1, k + 1):
        hh = h[:j].copy()
        h[0] = 0.0
        for i in range(j):
            li = l + i + 1
            lj = li - j
            f = hh[i] / (t[li] - t[lj])
            h[i] += f * (t[li] - x)
            h[i + 1] = f * (x - t[lj])
    return h


def _fpgivs(piv: float, ww: float) -> Tuple[float, float, float]:
    """Givens rotation zeroing ``piv`` against diagonal ``ww``.

    Returns (new_ww, cos, sin) — FITPACK's exact formulation (relative
    hypot, not np.hypot) so rounding matches.
    """
    store = abs(piv)
    if store >= ww:
        dd = store * np.sqrt(1.0 + (ww / piv) ** 2)
    else:
        dd = ww * np.sqrt(1.0 + (piv / ww) ** 2)
    return dd, ww / dd, piv / dd


def _fpback(a: np.ndarray, z: np.ndarray, n: int, k: int) -> np.ndarray:
    """Back substitution for the banded upper triangle ``a`` (n x k)."""
    c = np.zeros(n)
    c[n - 1] = z[n - 1] / a[n - 1, 0]
    for i in range(n - 2, -1, -1):
        store = z[i]
        i1 = min(k - 1, n - 1 - i)
        for l in range(1, i1 + 1):
            store -= c[i + l] * a[i, l]
        c[i] = store / a[i, 0]
    return c


def _fpdisc(t: np.ndarray, n: int, k2: int) -> np.ndarray:
    """Discontinuity-jump matrix of the k-th derivative at interior knots.

    Returns b of shape (n - 2*k2 + 1? , k2) — one row per interior knot,
    k2 = k + 2 entries each (FITPACK fpdisc).
    """
    k1 = k2 - 1
    k = k1 - 1
    nk1 = n - k1
    nrint = nk1 - k
    fac = nrint / (t[nk1] - t[k1 - 1])
    n_rows = nk1 - k1
    b = np.zeros((max(n_rows, 0), k2))
    h = np.zeros(2 * k1)
    for l in range(k1, nk1):        # 0-based knot index of t(l+1) in Fortran
        lmk = l - k1
        for j in range(k1):
            h[j] = t[l] - t[l + j - k1]        # t(l) - t(l+j+1-k2) 1-based
            h[j + k1] = t[l] - t[l + j + 1]
        lp = lmk
        for j in range(k2):
            jk = j
            prod = h[j]
            for _ in range(k):
                jk += 1
                prod *= h[jk] * fac
            lk = lp + k1
            b[lmk, j] = (t[lk] - t[lp]) / prod
            lp += 1
    return b


def _fprati(p1, f1, p2, f2, p3, f3):
    """Rational-interpolation step for the root of f(p) = 0.

    Returns (p, p1, f1, p3, f3) with the bracket adjusted so f1 > 0 > f3
    (p3 < 0 encodes p3 = infinity).
    """
    if p3 > 0.0:
        h1 = f1 * (f2 - f3)
        h2 = f2 * (f3 - f1)
        h3 = f3 * (f1 - f2)
        p = -(p1 * p2 * h3 + p2 * p3 * h1 + p1 * p3 * h2) / (
            p1 * h1 + p2 * h2 + p3 * h3
        )
    else:
        p = (p1 * (f1 - f3) * f2 - p2 * (f2 - f3) * f1) / ((f1 - f2) * f3)
    if f2 < 0.0:
        p3, f3 = p2, f2
    else:
        p1, f1 = p2, f2
    return p, p1, f1, p3, f3


def _fpknot(x, t, n, fpint, nrdata, nrint, k):
    """Insert one knot where the residual sum is largest (FITPACK fpknot).

    All arrays are Python lists here (cheap inserts); returns updated
    (t, n, fpint, nrdata, nrint). ``k`` is the spline degree.
    """
    fpmax = 0.0
    number = -1
    maxpt = 0
    maxbeg = 0
    jbegin = 0           # istart = 1 in Fortran; x indices here 0-based
    for j in range(nrint):
        jpoint = nrdata[j]
        if fpint[j] > fpmax and jpoint != 0:
            fpmax = fpint[j]
            number = j
            maxpt = jpoint
            maxbeg = jbegin
        jbegin += jpoint + 1
    if number < 0:
        # No splittable interval (all residual mass on zero-point
        # intervals): a negative index would silently corrupt the tail.
        return t, n, fpint, nrdata, nrint
    # New knot at the data point halving the fullest interval.
    ihalf = maxpt // 2 + 1
    nrx = maxbeg + ihalf        # 0-based index into x
    nxt = number + 1
    # Split the bookkeeping of interval `number`.
    an = ihalf - 1
    am = maxpt
    fp_num = fpmax * an / am
    an2 = maxpt - ihalf
    fp_nxt = fpmax * an2 / am
    nrdata.insert(nxt, maxpt - ihalf)
    nrdata[number] = ihalf - 1
    fpint.insert(nxt, fp_nxt)
    fpint[number] = fp_num
    # Knot position: t(number + k + 2) in 1-based Fortran = index
    # number + k + 1 in 0-based.
    t.insert(number + k + 1, x[nrx])
    return t, n + 1, fpint, nrdata, nrint + 1


def curfit(
    x: np.ndarray,
    y: np.ndarray,
    k: int = 3,
    s: float = 0.0,
    w: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """Smoothing-spline fit replicating ``scipy.interpolate.UnivariateSpline``.

    scipy calls fpcurf0 with ``nest = max(m//2, 2k+2)`` first and, when the
    knots fill that allocation (ier=1), resumes the SAME fit (fpcurf1,
    iopt=1) with the maximal ``nest = m+k+1``. The nest cap truncates knot
    additions mid-round, which changes the final knot vector — so the
    two-stage dance is replicated here verbatim.

    Args:
        x: strictly increasing abscissae (m,).
        y: ordinates (m,).
        k: spline degree, 1 <= k <= 5, k < m.
        s: smoothing factor (>= 0; 0 = interpolation).
        w: positive weights (default all-ones).

    Returns (t, c, fp, ier): knot vector, b-spline coefficients (len(t) -
    k - 1 of them meaningful), the achieved weighted sum of squared
    residuals, and FITPACK's ier code (0, -1 interpolating, -2 polynomial,
    2/3 non-convergence — coefficients still usable, matching scipy).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    m = x.size
    if w is None:
        w = np.ones(m)
    else:
        w = np.asarray(w, dtype=np.float64)
    if not 1 <= k <= 5:
        raise FitpackError(f"degree k={k} outside 1..5")
    if m <= k:
        raise FitpackError(f"m={m} data points cannot fit degree {k}")
    if s < 0:
        raise FitpackError(f"negative smoothing factor s={s}")
    if np.any(np.diff(x) <= 0):
        raise FitpackError("x must be strictly increasing")
    if np.any(w <= 0):
        raise FitpackError("weights must be positive")

    try:
        from .._native import native_decoder

        return native_decoder().curfit(x, y, w, k, s)
    except ValueError:
        raise FitpackError("invalid curfit input") from None
    except Exception:
        pass  # no toolchain: pure-Python fallback below

    nest0 = m + k + 1 if s <= 0 else max(m // 2, 2 * (k + 1))
    t, c, fp, ier, state = _fpcurf(x, y, w, k, s, nest0)
    if ier == 1:
        # scipy's _reset_nest passes the capped call's ier (= 1) INTO
        # fpcurf1; FITPACK's knot-count rule checks `ier == 0`, so the
        # first continuation round adds exactly ONE knot before the
        # adaptive rule resumes. Replicate by threading ier through.
        t, c, fp, ier, state = _fpcurf(
            x, y, w, k, s, m + k + 1, state=state, ier_in=1
        )
    return t, c, fp, ier


def _fpcurf(
    x: np.ndarray,
    y: np.ndarray,
    w: np.ndarray,
    k: int,
    s: float,
    nest: int,
    state: Optional[dict] = None,
    ier_in: int = 0,
):
    """FITPACK fpcurf: iopt=0 when ``state`` is None, else the iopt=1
    continuation from a previous (nest-limited) call's returned state."""
    m = x.size
    k1 = k + 1
    k2 = k + 2
    nmin = 2 * k1
    nmax = m + k1
    xb, xe = x[0], x[m - 1]
    acc = _TOL * s

    # ---- initial knot set -------------------------------------------------
    def interpolation_knots():
        """Knots for s = 0 (or when part 1 reaches nmax)."""
        t = [0.0] * nmax
        mk1 = m - k1
        if mk1 > 0:
            k3 = k // 2
            if k % 2 == 1:
                for l in range(mk1):
                    t[k1 + l] = x[k3 + 1 + l]
            else:
                for l in range(mk1):
                    t[k1 + l] = (x[k3 + 1 + l] + x[k3 + l]) * 0.5
        return t, nmax

    interp = s <= 0.0
    if interp:
        t, n = interpolation_knots()
        fpint = [0.0] * nest
        nrdata = [0] * nest
        nplus = 0
        fpold = 0.0
        fp0 = 0.0
    elif state is not None and state["n"] > nmin and state["fp0"] > s:
        # iopt=1 continuation: resume from the previous call's knots and
        # restored fp0/fpold/nplus (FITPACK keeps them in fpint(n),
        # fpint(n-1), nrdata(n)).
        n = state["n"]
        t = list(state["t"]) + [0.0] * (nest - n)
        fpint = list(state["fpint"]) + [0.0] * (nest - len(state["fpint"]))
        nrdata = list(state["nrdata"]) + [0] * (nest - len(state["nrdata"]))
        fp0 = state["fp0"]
        fpold = state["fpold"]
        nplus = state["nplus"]
    else:
        n = nmin
        t = [0.0] * nmin
        fpold = 0.0
        nplus = 0
        fpint = [0.0] * nest
        nrdata = [0] * nest
        nrdata[0] = m - 2
        fp0 = 0.0

    # ---- part 1: least-squares splines over growing knot sets -------------
    def _mkstate():
        return {
            "t": list(t[:n]), "n": n,
            "fpint": list(fpint), "nrdata": list(nrdata),
            "fp0": fp0, "fpold": fpold, "nplus": nplus,
        }

    a = None
    z = None
    c = np.zeros(nest)
    q = np.zeros((m, k1))
    fp = 0.0
    fpms = 0.0
    ier = ier_in

    for _ in range(m):
        if n == nmin:
            ier = -2
        nrint = n - nmin + 1
        nk1 = n - k1
        # Boundary knots.
        for j in range(k1):
            t[j] = xb
            t[n - 1 - j] = xe

        # Least-squares spline on the current knots via Givens rotations.
        t_arr = np.asarray(t[:n])
        a = np.zeros((nk1, k1))
        z = np.zeros(nk1)
        fp = 0.0
        l = k1 - 1  # 0-based: t[l] <= x < t[l+1]
        for it in range(m):
            xi = x[it]
            wi = w[it]
            yi = y[it] * wi
            while not (xi < t_arr[l + 1] or l == nk1 - 1):
                l += 1
            h = _fpbspl(t_arr, k, xi, l)
            q[it, :] = h
            h = h * wi
            j = l - k1
            for i in range(k1):
                j += 1
                piv = h[i]
                if piv == 0.0:
                    continue
                a[j, 0], cos, sin = _fpgivs(piv, a[j, 0])
                yi, z[j] = cos * yi - sin * z[j], cos * z[j] + sin * yi
                if i == k1 - 1:
                    break
                i2 = 0
                for i1 in range(i + 1, k1):
                    i2 += 1
                    h[i1], a[j, i2] = (
                        cos * h[i1] - sin * a[j, i2],
                        cos * a[j, i2] + sin * h[i1],
                    )
            fp += yi * yi
        if ier == -2:
            fp0 = fp
        fpint[n - 1] = fp0
        fpint[n - 2] = fpold
        nrdata[n - 1] = nplus
        c[:nk1] = _fpback(a, z, nk1, k1)

        fpms = fp - s
        if _TRACE:
            print(f"    [fpcurf nest={nest}] n={n} interior={t[k1:n-k1]} "
                  f"fp={fp:.4f} fpms={fpms:.4f} nplus={nplus} fpold={fpold:.4f}")
        if abs(fpms) < acc:
            return np.asarray(t[:n]), c[:n].copy(), fp, ier, _mkstate()
        if fpms < 0.0:
            break  # accept knots; go smooth (part 2)
        if n == nmax:
            # Interpolating spline.
            return np.asarray(t[:n]), c[:n].copy(), fp, -1, _mkstate()
        if n == nest:
            # Storage cap: hand the full state back for an iopt=1 resume.
            return np.asarray(t[:n]), c[:n].copy(), fp, 1, _mkstate()
        # Number of knots to add.
        if ier != 0:
            nplus = 1
            ier = 0
        else:
            npl1 = nplus * 2
            if fpold - fp > acc:
                npl1 = int(nplus * fpms / (fpold - fp))
            nplus = min(nplus * 2, max(npl1, nplus // 2, 1))
        fpold = fp
        # Residual sum per knot interval.
        fpart = 0.0
        i = 0
        l = k2 - 1  # 0-based knot index of Fortran t(k2)
        new = False
        fpint_l = [0.0] * nrint
        for it in range(m):
            if not (x[it] < t_arr[l] or l > nk1 - 1):
                new = True
                l += 1
            term = 0.0
            l0 = l - k2
            for j in range(k1):
                l0 += 1
                term += c[l0] * q[it, j]
            term = (w[it] * (term - y[it])) ** 2
            fpart += term
            if new:
                store = term * 0.5
                fpint_l[i] = fpart - store
                i += 1
                fpart = store
                new = False
        fpint_l[nrint - 1] = fpart
        fpint[:nrint] = fpint_l
        hit_nmax = False
        if _TRACE:
            print(f"      nplus={nplus} fpint={[round(v,3) for v in fpint[:nrint]]} "
                  f"nrdata={nrdata[:nrint]}")
        for _ in range(nplus):
            t_list = list(t[:n])
            fp_list = list(fpint[:nrint])
            nr_list = list(nrdata[:nrint])
            t_list, n, fp_list, nr_list, nrint = _fpknot(
                x, t_list, n, fp_list, nr_list, nrint, k
            )
            t = t_list + [0.0] * (nest - n)
            fpint[:nrint] = fp_list
            nrdata[:nrint] = nr_list
            if n == nmax:
                hit_nmax = True
                break
            if n == nest:
                break
        if hit_nmax:
            # Relocate knots as for interpolation and loop once more.
            t, n = interpolation_knots()
    else:
        return np.asarray(t[:n]), c[:n].copy(), fp, 1, _mkstate()

    # ---- part 2: smoothing spline on the accepted knots --------------------
    nk1 = n - k1
    t_arr = np.asarray(t[:n])
    b = _fpdisc(t_arr, n, k2)
    n8 = n - nmin

    f1 = fp0 - s
    f3 = fpms
    p1 = 0.0
    p3 = -1.0
    # Sequential sum (not np.sum's pairwise): matches the Fortran and the
    # native C++ translation bit for bit.
    psum = 0.0
    for _i in range(nk1):
        psum += float(a[_i, 0])
    p = nk1 / psum
    ich1 = 0
    ich3 = 0
    for it_count in range(_MAXIT):
        pinv = 1.0 / p
        # Extend the triangle with the penalty rows, weight 1/p.
        g = np.zeros((nk1, k2))
        g[:, :k1] = a
        cc = z.copy()
        for it in range(n8):
            h = b[it] * pinv
            yi = 0.0
            for j in range(it, nk1):
                piv = h[0]
                g[j, 0], cos, sin = _fpgivs(piv, g[j, 0])
                yi, cc[j] = cos * yi - sin * cc[j], cos * cc[j] + sin * yi
                if j == nk1 - 1:
                    break
                i2 = k1
                if j > n8 - 1:
                    i2 = nk1 - 1 - j
                for i in range(1, i2 + 1):
                    h[i], g[j, i] = (
                        cos * h[i] - sin * g[j, i],
                        cos * g[j, i] + sin * h[i],
                    )
                h[:i2] = h[1:i2 + 1]
                h[i2] = 0.0
        c[:nk1] = _fpback(g, cc, nk1, k2)
        # f(p).
        fp = 0.0
        l = k2 - 1
        for it in range(m):
            if not (x[it] < t_arr[l] or l > nk1 - 1):
                l += 1
            l0 = l - k2
            term = 0.0
            for j in range(k1):
                l0 += 1
                term += c[l0] * q[it, j]
            fp += (w[it] * (term - y[it])) ** 2
        fpms = fp - s
        if abs(fpms) < acc:
            return t_arr.copy(), c[:n].copy(), fp, 0, _mkstate()
        if it_count == _MAXIT - 1:
            return t_arr.copy(), c[:n].copy(), fp, 3, _mkstate()
        p2, f2 = p, fpms
        if ich3 == 0:
            if f2 - f3 <= acc:
                # Initial choice of p too large.
                p3, f3 = p2, f2
                p = p * _CON4
                if p <= p1:
                    p = p1 * _CON9 + p2 * _CON1
                continue
            if f2 < 0.0:
                ich3 = 1
        if ich1 == 0:
            if f1 - f2 <= acc:
                # Initial choice of p too small.
                p1, f1 = p2, f2
                p = p / _CON4
                if p3 >= 0.0 and p >= p3:
                    p = p2 * _CON1 + p3 * _CON9
                continue
            if f2 > 0.0:
                ich1 = 1
        if f2 >= f1 or f2 <= f3:
            return t_arr.copy(), c[:n].copy(), fp, 2, _mkstate()
        p, p1, f1, p3, f3 = _fprati(p1, f1, p2, f2, p3, f3)
    return t_arr.copy(), c[:n].copy(), fp, 3, _mkstate()


def splev(xq, t: np.ndarray, c: np.ndarray, k: int):
    """Evaluate the b-spline (t, c, k) at ``xq`` (ext=0: extrapolate)."""
    t = np.asarray(t, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    xq_arr = np.atleast_1d(np.asarray(xq, dtype=np.float64))
    n = t.size
    k1 = k + 1
    nk1 = n - k1
    out = np.empty(xq_arr.size)
    for i, xv in enumerate(xq_arr):
        # t[l] <= x < t[l+1], clamped to the data interval (extrapolation
        # uses the end polynomial pieces — FITPACK splev with e=0).
        l = int(np.searchsorted(t, xv, side="right") - 1)
        l = min(max(l, k1 - 1), nk1 - 1)
        h = _fpbspl(t, k, xv, l)
        out[i] = float(np.dot(h, c[l - k: l + 1]))
    if np.isscalar(xq) or np.ndim(xq) == 0:
        return float(out[0])
    return out
