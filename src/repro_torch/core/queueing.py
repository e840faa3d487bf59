"""Lemma 1: closed-form M/G/1 mean response time for SPRPT-LP.

Evaluated numerically via the SOAP decomposition (Appendix C of the
paper; Scully & Harchol-Balter 2018):

    E[T(x,r)] = lambda * (I1(r) + I2(r, a0)) / (2 (1 - rho'_r)^2)
              + int_0^{min(x, a0)} da / (1 - rho'_{(r-a)+})
              + max(x - a0, 0)

    rho'_r    = lambda * int_{y<=r} int_x x   g(x,y) dx dy
    I1(r)     =          int_{y<=r} int_x x^2 g(x,y) dx dy
    I2(r,a0)  = int_{t>=r+a0} int_{x>=t-r} g(x,t) (x-(t-r))^2 dx dt

The paper writes the residence term as int_0^{a0} + (x - a0); for x < a0 the
job finishes while still preemptable, so we evaluate the natural
generalization with min(x, a0) and (x-a0)^+ (identical when x >= a0, the
regime the paper considers). a0 = C * r.

Prediction models (Appendix D):
  * exponential: g(x, y) = f(x) * exp(-y/x) / x  (prediction ~ Exp(mean x))
  * perfect:     g(x, y) = f(x) * delta(y - x)

All inner integrals are precomputed once on a grid (cumulative trapezoid)
and interpolated, so a full E[T] evaluation is vectorized numpy. The test
suite cross-validates against the discrete-event simulator.

A copy of the reference package's ``core/queueing.py`` (pure numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MG1Config:
    """Parameters of the Appendix-D M/G/1 SPRPT-LP closed form."""

    lam: float = 0.5            # Poisson arrival rate (rho = lam * E[X] < 1)
    C: float = 0.8              # preemption budget multiplier
    prediction: str = "exponential"   # "exponential" | "perfect"
    x_max: float = 16.0         # integration cutoff (Exp(1) tail ~ e^-16)
    n_grid: int = 400


def service_density(x):
    """f(x) = e^{-x} (exponential, mean 1, as in Appendix D)."""
    return np.exp(-x)


class Lemma1:
    """Precomputed SOAP terms for one (lam, C, prediction model)."""

    def __init__(self, cfg: MG1Config):
        self.cfg = cfg
        n = cfg.n_grid
        self.xs = np.linspace(1e-4, cfg.x_max, n)
        xs = self.xs
        if cfg.prediction == "perfect":
            # g(x,y) = f(x) delta(y-x): moments below r collapse to x <= r
            fx = service_density(xs)
            self._m1 = _cumtrapz(xs * fx, xs)            # int_{x<=r} x f
            self._m2 = _cumtrapz(xs ** 2 * fx, xs)
        else:
            # m_k(y) = int_x x^k g(x,y) dx  on a y grid, then cumint over y
            ys = xs
            X, Y = np.meshgrid(xs, ys, indexing="ij")
            G = service_density(X) * np.exp(-Y / X) / X
            m1y = np.trapezoid(X * G, xs, axis=0)        # (n_y,)
            m2y = np.trapezoid(X ** 2 * G, xs, axis=0)
            self._m1 = _cumtrapz(m1y, ys)
            self._m2 = _cumtrapz(m2y, ys)

    # -- interpolated terms -------------------------------------------------
    def rho_prime(self, r):
        """Truncated load rho'(r) = lam * E[min(X, r)-ish mass below r]."""
        return self.cfg.lam * np.interp(r, self.xs, self._m1)

    def i1(self, r):
        """Second moment of service mass below rank r (interpolated)."""
        return np.interp(r, self.xs, self._m2)

    def i2(self, r):
        """Recycled second moment; depends on r via a0 = C r."""
        cfg = self.cfg
        a0 = cfg.C * r
        if cfg.prediction == "perfect":
            # t = x: recycled iff x - r >= a0; served r each -> r^2 * P(x >= r+a0)
            return r * r * np.exp(-(r + a0))
        ts = np.linspace(r + a0 + 1e-5, cfg.x_max + r + a0, 300)
        xs = self.xs
        X = xs[None, :]
        Tm = ts[:, None]
        G = service_density(X) * np.exp(-Tm / X) / X
        w = np.where(X >= (Tm - r), (X - (Tm - r)) ** 2, 0.0)
        inner = np.trapezoid(G * w, xs, axis=1)
        return float(np.trapezoid(inner, ts))

    def response_xr(self, x, r):
        """E[T(x, r)] per Lemma 1."""
        cfg = self.cfg
        a0 = cfg.C * r
        rp = self.rho_prime(r)
        wait = cfg.lam * (self.i1(r) + self.i2(r)) / (2.0 * (1.0 - rp) ** 2)
        a_hi = min(x, a0)
        a_grid = np.linspace(0.0, max(a_hi, 1e-9), 160)
        denom = 1.0 - self.rho_prime(np.maximum(r - a_grid, 0.0))
        residence = np.trapezoid(1.0 / denom, a_grid) + max(x - a0, 0.0)
        return float(wait + residence)

    def mean_response(self, n_xr: int = 32):
        """E[T] = E_{(x,r)~g}[T(x,r)].

        For the exponential model the prediction scales with x, so we
        integrate with the substitution r = x*u, u ~ Exp(1): a linear grid
        in r cannot resolve the conditional density for small x.
        """
        cfg = self.cfg
        xs = np.linspace(0.02, cfg.x_max * 0.7, n_xr)
        wx = service_density(xs)
        if cfg.prediction == "perfect":
            vals = np.array([self.response_xr(x, x) for x in xs])
            return float(np.trapezoid(vals * wx, xs) / np.trapezoid(wx, xs))
        us = np.linspace(1e-3, 8.0, 48)
        wu = np.exp(-us)
        vals = np.array([
            np.trapezoid(np.array([self.response_xr(x, x * u) for u in us]) * wu, us)
            / np.trapezoid(wu, us)
            for x in xs])
        return float(np.trapezoid(vals * wx, xs) / np.trapezoid(wx, xs))


def _cumtrapz(y, x):
    """Cumulative trapezoidal integral of y over grid x."""
    out = np.zeros_like(y)
    out[1:] = np.cumsum((y[1:] + y[:-1]) / 2.0 * np.diff(x))
    return out


def mean_response(cfg: MG1Config, n_xr: int = 32) -> float:
    """Mean response time of the Lemma-1 closed form under ``cfg``."""
    return Lemma1(cfg).mean_response(n_xr)


def sweep_C(lam: float, cs, prediction: str = "exponential"):
    """Theory curve for the Appendix-D comparison."""
    return {c: mean_response(MG1Config(lam=lam, C=c, prediction=prediction))
            for c in cs}
