// Native smoothing-spline fit: C++ translation of track/fitpack.py's
// FITPACK curfit port (itself validated knot/coeff-exact against scipy's
// UnivariateSpline). The Python port's per-point Givens loops cost ~0.6-3 s
// per fit on noisy 300-600 point histories, and the figure path refits per
// frame; this translation follows the SAME scalar operation order (compile
// with -ffp-contract=off so no FMA re-rounding creeps in) and runs
// ~150-400x faster (measured at m=300 / m=600 noisy histories). Part 1
// (knot placement) is bit-identical to the Python port by construction;
// part 2 converges to the same tolerance.
//
// Entry point: curfit_univariate() — the two-stage nest dance
// (fpcurf0 with nest = max(m/2, 2k+2), then the fpcurf1 continuation with
// ier passed through) replicating scipy's UnivariateSpline exactly.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double TOL = 1e-3;
constexpr int MAXIT = 20;
constexpr double CON1 = 0.1, CON9 = 0.9, CON4 = 0.04;

// The (k+1) b-splines of degree k non-zero at x, t[l] <= x < t[l+1].
inline void fpbspl(const double* t, int k, double x, long l, double* h) {
    double hh[6];
    h[0] = 1.0;
    for (int j = 1; j <= k; ++j) {
        for (int i = 0; i < j; ++i) hh[i] = h[i];
        h[0] = 0.0;
        for (int i = 0; i < j; ++i) {
            long li = l + i + 1;
            long lj = li - j;
            double f = hh[i] / (t[li] - t[lj]);
            h[i] += f * (t[li] - x);
            h[i + 1] = f * (x - t[lj]);
        }
    }
}

// Givens rotation zeroing piv against diagonal ww (FITPACK formulation).
inline void fpgivs(double piv, double& ww, double& cos_, double& sin_) {
    double store = std::fabs(piv);
    double dd;
    if (store >= ww) dd = store * std::sqrt(1.0 + (ww / piv) * (ww / piv));
    else dd = ww * std::sqrt(1.0 + (piv / ww) * (piv / ww));
    cos_ = ww / dd;
    sin_ = piv / dd;
    ww = dd;
}

// Back substitution for the banded upper triangle a (n x k, row-major lda=k).
inline void fpback(const double* a, const double* z, long n, int k, int lda,
                   double* c) {
    c[n - 1] = z[n - 1] / a[(n - 1) * lda + 0];
    for (long i = n - 2; i >= 0; --i) {
        double store = z[i];
        long i1 = k - 1;
        if (n - 1 - i < i1) i1 = n - 1 - i;
        for (long l = 1; l <= i1; ++l) store -= c[i + l] * a[i * lda + l];
        c[i] = store / a[i * lda + 0];
    }
}

// Discontinuity-jump matrix rows (FITPACK fpdisc); b is (n_rows x k2).
inline void fpdisc(const double* t, long n, int k2, double* b) {
    int k1 = k2 - 1;
    int k = k1 - 1;
    long nk1 = n - k1;
    long nrint = nk1 - k;
    double fac = (double)nrint / (t[nk1] - t[k1 - 1]);
    double h[12];
    for (long l = k1; l < nk1; ++l) {
        long lmk = l - k1;
        for (int j = 0; j < k1; ++j) {
            h[j] = t[l] - t[l + j - k1];
            h[j + k1] = t[l] - t[l + j + 1];
        }
        long lp = lmk;
        for (int j = 0; j < k2; ++j) {
            int jk = j;
            double prod = h[j];
            for (int i = 0; i < k; ++i) {
                jk += 1;
                prod *= h[jk] * fac;
            }
            long lk = lp + k1;
            b[lmk * k2 + j] = (t[lk] - t[lp]) / prod;
            lp += 1;
        }
    }
}

// Rational-interpolation root step; adjusts the bracket in place.
inline double fprati(double& p1, double& f1, double p2, double f2,
                     double& p3, double& f3) {
    double p;
    if (p3 > 0.0) {
        double h1 = f1 * (f2 - f3);
        double h2 = f2 * (f3 - f1);
        double h3 = f3 * (f1 - f2);
        p = -(p1 * p2 * h3 + p2 * p3 * h1 + p1 * p3 * h2) /
            (p1 * h1 + p2 * h2 + p3 * h3);
    } else {
        p = (p1 * (f1 - f3) * f2 - p2 * (f2 - f3) * f1) / ((f1 - f2) * f3);
    }
    if (f2 < 0.0) { p3 = p2; f3 = f2; }
    else { p1 = p2; f1 = f2; }
    return p;
}

// Insert one knot where the residual sum is largest (FITPACK fpknot).
inline void fpknot(const double* x, double* t, long& n, double* fpint,
                   long* nrdata, long& nrint, int k) {
    double fpmax = 0.0;
    long number = -1, maxpt = 0, maxbeg = 0, jbegin = 0;
    for (long j = 0; j < nrint; ++j) {
        long jpoint = nrdata[j];
        if (fpint[j] > fpmax && jpoint != 0) {
            fpmax = fpint[j];
            number = j;
            maxpt = jpoint;
            maxbeg = jbegin;
        }
        jbegin += jpoint + 1;
    }
    if (number < 0) return;  // no splittable interval: nothing to insert
    long ihalf = maxpt / 2 + 1;
    long nrx = maxbeg + ihalf;
    long nxt = number + 1;
    // Shift [nxt, nrint) right by one in fpint/nrdata; knots shift at
    // index number + k + 1.
    for (long j = nrint; j > nxt; --j) {
        fpint[j] = fpint[j - 1];
        nrdata[j] = nrdata[j - 1];
    }
    for (long j = n; j > number + k + 1; --j) t[j] = t[j - 1];
    nrdata[number] = ihalf - 1;
    nrdata[nxt] = maxpt - ihalf;
    double am = (double)maxpt;
    fpint[number] = fpmax * (double)(ihalf - 1) / am;
    fpint[nxt] = fpmax * (double)(maxpt - ihalf) / am;
    t[number + k + 1] = x[nrx];
    n += 1;
    nrint += 1;
}

struct FpState {
    std::vector<double> t;
    long n = 0;
    std::vector<double> fpint;
    std::vector<long> nrdata;
    double fp0 = 0.0, fpold = 0.0;
    long nplus = 0;
};

void interpolation_knots(const double* x, long m, int k, double* t, long& n) {
    int k1 = k + 1;
    long nmax = m + k1;
    long mk1 = m - k1;
    for (long j = 0; j < nmax; ++j) t[j] = 0.0;
    if (mk1 > 0) {
        int k3 = k / 2;
        if (k % 2 == 1) {
            for (long l = 0; l < mk1; ++l) t[k1 + l] = x[k3 + 1 + l];
        } else {
            for (long l = 0; l < mk1; ++l)
                t[k1 + l] = (x[k3 + 1 + l] + x[k3 + l]) * 0.5;
        }
    }
    n = nmax;
}

// fpcurf: iopt=0 when state.n == 0, else the iopt=1 continuation.
// Returns ier; fills t_out/c_out/n_out/fp_out and updates state.
int fpcurf(const double* x, const double* y, const double* w, long m,
           int k, double s, long nest, int ier_in, FpState& state,
           double* t_out, double* c_out, long* n_out, double* fp_out) {
    int k1 = k + 1;
    int k2 = k + 2;
    long nmin = 2 * k1;
    long nmax = m + k1;
    double xb = x[0], xe = x[m - 1];
    double acc = TOL * s;
    bool interp = s <= 0.0;

    std::vector<double> t(nest, 0.0);
    std::vector<double> fpint(nest, 0.0);
    std::vector<long> nrdata(nest, 0);
    long n;
    double fp0 = 0.0, fpold = 0.0;
    long nplus = 0;

    if (interp) {
        interpolation_knots(x, m, k, t.data(), n);
    } else if (state.n > nmin && state.fp0 > s) {
        n = state.n;
        for (long j = 0; j < state.n; ++j) t[j] = state.t[j];
        for (size_t j = 0; j < state.fpint.size() && j < (size_t)nest; ++j)
            fpint[j] = state.fpint[j];
        for (size_t j = 0; j < state.nrdata.size() && j < (size_t)nest; ++j)
            nrdata[j] = state.nrdata[j];
        fp0 = state.fp0;
        fpold = state.fpold;
        nplus = state.nplus;
    } else {
        n = nmin;
        nrdata[0] = m - 2;
    }

    std::vector<double> a, z, q(m * k1), c(nest, 0.0), g, bdisc;
    double fp = 0.0, fpms = 0.0;
    int ier = ier_in;

    auto save_state = [&]() {
        state.t.assign(t.begin(), t.begin() + n);
        state.n = n;
        state.fpint.assign(fpint.begin(), fpint.end());
        state.nrdata.assign(nrdata.begin(), nrdata.end());
        state.fp0 = fp0;
        state.fpold = fpold;
        state.nplus = nplus;
    };
    auto emit = [&](int code) {
        for (long j = 0; j < n; ++j) t_out[j] = t[j];
        for (long j = 0; j < n; ++j) c_out[j] = (j < n) ? c[j] : 0.0;
        *n_out = n;
        *fp_out = fp;
        save_state();
        return code;
    };

    long nk1 = 0;
    bool accepted = false;
    for (long iter = 0; iter < m; ++iter) {
        if (n == nmin) ier = -2;
        long nrint = n - nmin + 1;
        nk1 = n - k1;
        for (int j = 0; j < k1; ++j) {
            t[j] = xb;
            t[n - 1 - j] = xe;
        }

        a.assign(nk1 * k1, 0.0);
        z.assign(nk1, 0.0);
        fp = 0.0;
        long l = k1 - 1;
        for (long it = 0; it < m; ++it) {
            double xi = x[it];
            double wi = w[it];
            double yi = y[it] * wi;
            while (!(xi < t[l + 1] || l == nk1 - 1)) l += 1;
            double h[6];
            fpbspl(t.data(), k, xi, l, h);
            for (int i = 0; i < k1; ++i) {
                q[it * k1 + i] = h[i];
                h[i] = h[i] * wi;
            }
            long j = l - k1;
            for (int i = 0; i < k1; ++i) {
                j += 1;
                double piv = h[i];
                if (piv == 0.0) continue;
                double cos_, sin_;
                fpgivs(piv, a[j * k1 + 0], cos_, sin_);
                {
                    double s1 = yi, s2 = z[j];
                    z[j] = cos_ * s2 + sin_ * s1;
                    yi = cos_ * s1 - sin_ * s2;
                }
                if (i == k1 - 1) break;
                int i2 = 0;
                for (int i1 = i + 1; i1 < k1; ++i1) {
                    i2 += 1;
                    double s1 = h[i1], s2 = a[j * k1 + i2];
                    a[j * k1 + i2] = cos_ * s2 + sin_ * s1;
                    h[i1] = cos_ * s1 - sin_ * s2;
                }
            }
            fp += yi * yi;
        }
        if (ier == -2) fp0 = fp;
        fpint[n - 1] = fp0;
        fpint[n - 2] = fpold;
        nrdata[n - 1] = nplus;
        fpback(a.data(), z.data(), nk1, k1, k1, c.data());

        fpms = fp - s;
        if (std::fabs(fpms) < acc) return emit(ier);
        if (fpms < 0.0) { accepted = true; break; }
        if (n == nmax) return emit(-1);
        if (n == nest) return emit(1);
        if (ier != 0) {
            nplus = 1;
            ier = 0;
        } else {
            long npl1 = nplus * 2;
            if (fpold - fp > acc)
                npl1 = (long)((double)nplus * fpms / (fpold - fp));
            long cand = npl1;
            if (nplus / 2 > cand) cand = nplus / 2;
            if (1 > cand) cand = 1;
            nplus = nplus * 2 < cand ? nplus * 2 : cand;
        }
        fpold = fp;
        // Residual sum per knot interval.
        {
            double fpart = 0.0;
            long i = 0;
            long lpt = k2 - 1;
            bool newint = false;
            std::vector<double> fpint_l(nrint, 0.0);
            for (long it = 0; it < m; ++it) {
                if (!(x[it] < t[lpt] || lpt > nk1 - 1)) {
                    newint = true;
                    lpt += 1;
                }
                double term = 0.0;
                long l0 = lpt - k2;
                for (int j = 0; j < k1; ++j) {
                    l0 += 1;
                    term += c[l0] * q[it * k1 + j];
                }
                term = w[it] * (term - y[it]);
                term = term * term;
                fpart += term;
                if (newint) {
                    double store = term * 0.5;
                    fpint_l[i] = fpart - store;
                    i += 1;
                    fpart = store;
                    newint = false;
                }
            }
            fpint_l[nrint - 1] = fpart;
            for (long j = 0; j < nrint; ++j) fpint[j] = fpint_l[j];
        }
        bool hit_nmax = false;
        for (long j = 0; j < nplus; ++j) {
            long nrint_l = nrint;
            fpknot(x, t.data(), n, fpint.data(), nrdata.data(), nrint_l, k);
            nrint = nrint_l;
            if (n == nmax) { hit_nmax = true; break; }
            if (n == nest) break;
        }
        if (hit_nmax) {
            interpolation_knots(x, m, k, t.data(), n);
        }
    }
    if (!accepted) return emit(1);

    // ---- part 2: smoothing spline on the accepted knots ----
    nk1 = n - k1;
    bdisc.assign((nk1 - k1 > 0 ? (nk1 - k1) : 0) * k2, 0.0);
    fpdisc(t.data(), n, k2, bdisc.data());
    long n8 = n - nmin;

    double f1 = fp0 - s;
    double f3 = fpms;
    double p1 = 0.0;
    double p3 = -1.0;
    double psum = 0.0;
    for (long i = 0; i < nk1; ++i) psum += a[i * k1 + 0];
    double p = (double)nk1 / psum;
    int ich1 = 0, ich3 = 0;
    std::vector<double> cc(nk1);
    for (int it_count = 0; it_count < MAXIT; ++it_count) {
        double pinv = 1.0 / p;
        g.assign(nk1 * k2, 0.0);
        for (long i = 0; i < nk1; ++i) {
            for (int j = 0; j < k1; ++j) g[i * k2 + j] = a[i * k1 + j];
            cc[i] = z[i];
        }
        double h[8];
        for (long it = 0; it < n8; ++it) {
            for (int j = 0; j < k2; ++j) h[j] = bdisc[it * k2 + j] * pinv;
            double yi = 0.0;
            for (long j = it; j < nk1; ++j) {
                double piv = h[0];
                double cos_, sin_;
                fpgivs(piv, g[j * k2 + 0], cos_, sin_);
                {
                    double s1 = yi, s2 = cc[j];
                    cc[j] = cos_ * s2 + sin_ * s1;
                    yi = cos_ * s1 - sin_ * s2;
                }
                if (j == nk1 - 1) break;
                long i2 = k1;
                if (j > n8 - 1) i2 = nk1 - 1 - j;
                for (long i = 1; i <= i2; ++i) {
                    double s1 = h[i], s2 = g[j * k2 + i];
                    g[j * k2 + i] = cos_ * s2 + sin_ * s1;
                    h[i] = cos_ * s1 - sin_ * s2;
                }
                for (long i = 0; i < i2; ++i) h[i] = h[i + 1];
                h[i2] = 0.0;
            }
        }
        fpback(g.data(), cc.data(), nk1, k2, k2, c.data());
        fp = 0.0;
        long lpt = k2 - 1;
        for (long it = 0; it < m; ++it) {
            if (!(x[it] < t[lpt] || lpt > nk1 - 1)) lpt += 1;
            long l0 = lpt - k2;
            double term = 0.0;
            for (int j = 0; j < k1; ++j) {
                l0 += 1;
                term += c[l0] * q[it * k1 + j];
            }
            double r = w[it] * (term - y[it]);
            fp += r * r;
        }
        fpms = fp - s;
        if (std::fabs(fpms) < acc) return emit(0);
        if (it_count == MAXIT - 1) return emit(3);
        double p2 = p, f2 = fpms;
        if (ich3 == 0) {
            if (f2 - f3 <= acc) {
                p3 = p2;
                f3 = f2;
                p = p * CON4;
                if (p <= p1) p = p1 * CON9 + p2 * CON1;
                continue;
            }
            if (f2 < 0.0) ich3 = 1;
        }
        if (ich1 == 0) {
            if (f1 - f2 <= acc) {
                p1 = p2;
                f1 = f2;
                p = p / CON4;
                if (p3 >= 0.0 && p >= p3) p = p2 * CON1 + p3 * CON9;
                continue;
            }
            if (f2 > 0.0) ich1 = 1;
        }
        if (f2 >= f1 || f2 <= f3) return emit(2);
        p = fprati(p1, f1, p2, f2, p3, f3);
    }
    return emit(3);
}

}  // namespace

extern "C" {

// Two-stage UnivariateSpline-equivalent fit. t_out/c_out must hold
// m + k + 1 doubles. Returns FITPACK's ier (or -10 for invalid input).
int curfit_univariate(const double* x, const double* y, const double* w,
                      int64_t m, int k, double s,
                      double* t_out, double* c_out, int64_t* n_out,
                      double* fp_out) {
    if (k < 1 || k > 5 || m <= k || s < 0.0) return -10;
    for (long i = 1; i < m; ++i)
        if (!(x[i] > x[i - 1])) return -10;
    for (long i = 0; i < m; ++i)
        if (!(w[i] > 0.0)) return -10;

    long nest0 = (s <= 0.0) ? (m + k + 1)
                            : std::max<long>(m / 2, 2 * (k + 1));
    FpState state;
    long n = 0;
    int ier = fpcurf(x, y, w, m, k, s, nest0, 0, state, t_out, c_out,
                     &n, fp_out);
    if (ier == 1) {
        ier = fpcurf(x, y, w, m, k, s, m + k + 1, 1, state, t_out, c_out,
                     &n, fp_out);
    }
    *n_out = n;
    return ier;
}

}  // extern "C"
