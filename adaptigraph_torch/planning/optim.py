"""Black-box optimisers for online physics-parameter estimation: the
port's own copy of adaptigraph_tpu/planning/optim.py (numpy only, the same
seeds and the same arithmetic, so it gives the JAX package's numbers).

Replacements for the reference's skopt and cma dependencies: a GP with a
Matern-5/2 + white-noise kernel and expected-improvement acquisition (20
initial points), and CMA-ES (sigma 0.2 in the box [-0.2, 1.2]). The
expensive part, the objective (a batched GNN replay), runs on the device.
"""

from __future__ import annotations

import numpy as np


def _matern52(x1, x2, length_scale):
    d = np.linalg.norm(x1[:, None] - x2[None], axis=-1) / length_scale
    s5 = np.sqrt(5.0) * d
    return (1.0 + s5 + 5.0 / 3.0 * d**2) * np.exp(-s5)


class GaussianProcess:
    """GP regression with Matern-5/2 + white noise, y-normalization."""

    def __init__(self, length_scale=1.0, noise=1e-4):
        self.length_scale = length_scale
        self.noise = noise

    def fit(self, x, y, optimize_hypers: bool = False):
        self.x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64)
        self.y_mean, self.y_std = y.mean(), y.std() + 1e-12
        self.y = (y - self.y_mean) / self.y_std
        if optimize_hypers:
            self._optimize_hypers()
        self._refit()
        return self

    def _refit(self):
        k = _matern52(self.x, self.x, self.length_scale)
        k[np.diag_indices_from(k)] += self.noise / (self.y_std**2) + 1e-8
        self.l = np.linalg.cholesky(k)
        self.alpha = np.linalg.solve(self.l.T, np.linalg.solve(self.l, self.y))

    def _optimize_hypers(self):
        """Grid marginal-likelihood maximization over (length_scale, noise)
        — the role of the reference's n_restarts_optimizer=10 GP refit
        (physics_param_optimizer.py:94); a fixed length scale over-smooths
        the posterior mean and drags expected_minimum off the optimum."""
        span = float(np.ptp(self.x, axis=0).max()) or 1.0
        best = (self.length_scale, self.noise, -np.inf)
        noise0 = max(self.noise, 1e-10)
        for ls in span * np.array([0.05, 0.1, 0.2, 0.4, 0.8, 1.5]):
            for nz in [noise0 * f for f in (0.01, 0.1, 1.0)]:
                k = _matern52(self.x, self.x, ls)
                k[np.diag_indices_from(k)] += nz / (self.y_std**2) + 1e-8
                try:
                    l = np.linalg.cholesky(k)
                except np.linalg.LinAlgError:
                    continue
                a = np.linalg.solve(l.T, np.linalg.solve(l, self.y))
                ll = (-0.5 * float(self.y @ a)
                      - float(np.sum(np.log(np.diag(l)))))
                if ll > best[2]:
                    best = (ls, nz, ll)
        self.length_scale, self.noise = best[0], best[1]

    def predict(self, xq):
        xq = np.atleast_2d(np.asarray(xq, np.float64))
        ks = _matern52(xq, self.x, self.length_scale)
        mu = ks @ self.alpha
        v = np.linalg.solve(self.l, ks.T)
        var = np.clip(1.0 - np.sum(v**2, axis=0), 1e-12, None)
        return mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std


def _norm_pdf(z):
    return np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)


def _norm_cdf(z):
    from math import erf

    return 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))


def gp_minimize_ei(func, bounds, n_calls: int = 50, n_initial: int = 20,
                   noise_level: float = 1e-3, random_state: int = 42,
                   n_candidates: int = 2048):
    """Sequential GP-EI minimization over a box.

    Args:
      func: x (dim,) -> float.
      bounds: [(lo, hi)] * dim.
      n_calls / n_initial: evaluation budget / random warmup (reference
        budgets: 50 / 20).
      noise_level: observation noise std for the GP's white kernel.

    Returns: dict(x, fun, x_iters, func_vals, expected_x) where expected_x is
      the GP posterior-mean minimizer (the reference's expected_minimum).
    """
    rng = np.random.RandomState(random_state)
    bounds = np.asarray(bounds, np.float64)
    dim = len(bounds)

    def sample(n):
        return rng.uniform(bounds[:, 0], bounds[:, 1], size=(n, dim))

    n_init = min(n_initial, n_calls)
    if dim == 1:
        # deterministic uniform-grid warmup: in 1-D a grid guarantees an
        # observation within half a grid step of the argmin, which random
        # warmup does not (r5h rope refit: random warmup + a flat posterior
        # left expected_x 0.23 away from the landscape argmin)
        xs = list(np.linspace(bounds[0, 0], bounds[0, 1], n_init)[:, None])
    else:
        xs = list(sample(n_init))
    ys = [float(func(x)) for x in xs]

    gp = GaussianProcess(length_scale=1.0, noise=noise_level**2)
    while len(xs) < n_calls:
        gp.fit(np.array(xs), np.array(ys), optimize_hypers=True)
        cand = sample(n_candidates)
        mu, sigma = gp.predict(cand)
        best = min(ys)
        z = (best - mu) / (sigma + 1e-12)
        ei = (best - mu) * _norm_cdf(z) + sigma * _norm_pdf(z)
        x_next = cand[int(np.argmax(ei))]
        xs.append(x_next)
        ys.append(float(func(x_next)))

    gp.fit(np.array(xs), np.array(ys), optimize_hypers=True)
    cand = np.concatenate([sample(8192), np.array(xs)], axis=0)
    mu, _ = gp.predict(cand)
    expected_x = cand[int(np.argmin(mu))]
    i_best = int(np.argmin(ys))
    return {"x": np.array(xs[i_best]), "fun": ys[i_best], "x_iters": np.array(xs),
            "func_vals": np.array(ys), "expected_x": expected_x}


class CMAES:
    """(mu/mu_w, lambda)-CMA-ES with box constraints (Hansen's standard
    update equations), matching the reference budget interface."""

    def __init__(self, x0, sigma: float = 0.2, bounds=None, seed: int = 42,
                 popsize: int | None = None):
        self.dim = len(x0)
        self.mean = np.asarray(x0, np.float64).copy()
        self.sigma = sigma
        self.bounds = bounds
        self.rng = np.random.RandomState(seed)
        self.lam = popsize or (4 + int(3 * np.log(self.dim)))
        self.mu = self.lam // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.w = w / w.sum()
        self.mu_eff = 1.0 / np.sum(self.w**2)
        n = self.dim
        self.cc = (4 + self.mu_eff / n) / (n + 4 + 2 * self.mu_eff / n)
        self.cs = (self.mu_eff + 2) / (n + self.mu_eff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mu_eff)
        self.cmu = min(1 - self.c1,
                       2 * (self.mu_eff - 2 + 1 / self.mu_eff) / ((n + 2) ** 2 + self.mu_eff))
        self.damps = 1 + 2 * max(0, np.sqrt((self.mu_eff - 1) / (n + 1)) - 1) + self.cs
        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))
        self.best_x, self.best_f = self.mean.copy(), np.inf

    def ask(self):
        d, b = np.linalg.eigh(self.C)
        d = np.sqrt(np.maximum(d, 1e-20))
        self._bd = b * d
        z = self.rng.randn(self.lam, self.dim)
        x = self.mean + self.sigma * z @ self._bd.T
        if self.bounds is not None:
            x = np.clip(x, self.bounds[0], self.bounds[1])
        self._z = z
        return x

    def tell(self, x, f):
        order = np.argsort(f)
        if f[order[0]] < self.best_f:
            self.best_f = float(f[order[0]])
            self.best_x = x[order[0]].copy()
        z_sel = self._z[order[: self.mu]]
        x_sel = x[order[: self.mu]]
        old_mean = self.mean.copy()
        self.mean = self.w @ x_sel
        z_mean = self.w @ z_sel
        d, b = np.linalg.eigh(self.C)
        inv_sqrt = b @ np.diag(1 / np.sqrt(np.maximum(d, 1e-20))) @ b.T
        self.ps = (1 - self.cs) * self.ps + np.sqrt(
            self.cs * (2 - self.cs) * self.mu_eff) * inv_sqrt @ (
            (self.mean - old_mean) / self.sigma)
        hsig = (np.linalg.norm(self.ps) / np.sqrt(1 - (1 - self.cs) ** 2)
                < (1.4 + 2 / (self.dim + 1)) * self.chi_n)
        self.pc = (1 - self.cc) * self.pc + hsig * np.sqrt(
            self.cc * (2 - self.cc) * self.mu_eff) * (self.mean - old_mean) / self.sigma
        artmp = (x_sel - old_mean) / self.sigma
        self.C = ((1 - self.c1 - self.cmu) * self.C
                  + self.c1 * (np.outer(self.pc, self.pc)
                               + (not hsig) * self.cc * (2 - self.cc) * self.C)
                  + self.cmu * (artmp.T * self.w) @ artmp)
        self.sigma *= np.exp((self.cs / self.damps)
                             * (np.linalg.norm(self.ps) / self.chi_n - 1))

    def optimize(self, func, iterations: int = 50):
        for _ in range(iterations):
            x = self.ask()
            f = np.array([float(func(xi)) for xi in x])
            self.tell(x, f)
        return self.best_x, self.best_f
