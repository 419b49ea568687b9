"""Huber regression trainer matching sklearn.HuberRegressor semantics (JAX
``calib/huber.py``), with the samples as float64 tensors on one device.

sklearn minimizes, over (w, c, sigma > 0):

    sum_i sigma + H_eps((y_i - x_i.w - c) / sigma) * sigma  +  alpha * ||w||^2

with H_eps(z) = z^2 for |z| <= eps else 2*eps*|z| - eps^2, via L-BFGS.  As
in the JAX package the same objective is minimized by alternating IRLS on
(w, c) and a 1-D Newton solve for sigma.  Each IRLS round forms the
weighted normal equations over every sample and solves the small system on
the samples' device; only the scalars that the loops' tests read (the
Newton step's two sums, the objective) come to the host.  A fit returns
numpy arrays, as the JAX fit does.

The black trainer's global fit is the one device-sized piece of work in
the trainers: 1.44 M samples x 35 monomials a round at the real series'
size (``trainers/temperature_black.py``).

Used by the temperature-model trainers (``temperature_color_model.py:333-342``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vistaf_torch.calib.temp_weights import poly_powers


@dataclasses.dataclass
class HuberFit:
    coef: np.ndarray
    intercept: float
    sigma: float
    n_iter: int

    def predict(self, X: np.ndarray) -> np.ndarray:
        return X @ self.coef + self.intercept


def _median(v: torch.Tensor) -> torch.Tensor:
    """``np.median``: the middle value, or the mean of the two middle values
    of an even count (``torch.median`` takes the lower one)."""
    s = torch.sort(v).values
    n = s.numel()
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def _lstsq_min_norm(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``np.linalg.lstsq(A, y, rcond=None)[0]``: the least-norm least-squares
    solution, singular values below eps * max(m, n) of the largest dropped.
    The polynomial features carry a bias column beside the intercept's, so
    A is rank-deficient, which CUDA's only ``lstsq`` driver (QR) cannot
    take: A = QR, then the pseudo-inverse of the small R."""
    m, n = A.shape
    Q, R = torch.linalg.qr(A)
    rtol = float(np.finfo(np.float64).eps) * max(m, n)
    return torch.linalg.pinv(R, rtol=rtol) @ (Q.T @ y)


def _objective(X, y, w, c, sigma, eps, alpha) -> float:
    r = (y - X @ w - c) / sigma
    a = torch.abs(r)
    h = torch.where(a <= eps, r * r, 2 * eps * a - eps * eps)
    return float(torch.sum(sigma + h * sigma) + alpha * torch.dot(w, w))


def huber_fit(X: torch.Tensor, y: torch.Tensor, epsilon: float = 1.35,
              alpha: float = 1e-4, max_iter: int = 200,
              tol: float = 1e-10) -> HuberFit:
    """Fit the sklearn Huber objective by alternating minimization on the
    device of ``X`` (float64).

    For fixed sigma, (w, c) minimize a reweighted ridge problem; for fixed
    (w, c), sigma has a closed Newton update.  Alternation converges to the
    joint optimum for this convex objective.
    """
    X = torch.as_tensor(X, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64, device=X.device)
    n, d = X.shape
    Xa = torch.cat([X, torch.ones(n, 1, dtype=torch.float64, device=X.device)], dim=1)
    ridge = torch.zeros(d + 1, d + 1, dtype=torch.float64, device=X.device)
    ridge[:d, :d] = torch.eye(d, dtype=torch.float64, device=X.device)
    jitter = 1e-12 * torch.eye(d + 1, dtype=torch.float64, device=X.device)

    # init: OLS + residual scale
    beta = _lstsq_min_norm(Xa, y)
    w, c = beta[:d], beta[d]
    r = y - X @ w - c
    sigma = max(1.4826 * float(_median(torch.abs(r - _median(r)))), 1e-7)

    obj = _objective(X, y, w, c, sigma, epsilon, alpha)
    it = 0
    for it in range(max_iter):
        # --- IRLS for (w, c) at fixed sigma.
        # d/dw of sum H(r/sigma)*sigma: weights w_i = 1 if |z|<=eps else eps/|z|
        z = (y - X @ w - c) / sigma
        az = torch.abs(z)
        wts = torch.where(az <= epsilon, 1.0, epsilon / torch.clamp(az, min=1e-300))
        Xw = Xa * wts[:, None]
        # weighted normal equations + ridge on w only (not the intercept)
        Hmat = Xw.T @ Xa + (alpha * sigma) * ridge
        g = Xw.T @ y
        del Xw
        beta = torch.linalg.solve(Hmat + jitter, g)
        w_new, c_new = beta[:d], beta[d]

        # --- sigma update at fixed (w, c): minimize n*sigma + sum H(r/sigma)*sigma
        r = y - X @ w_new - c_new
        r2 = r * r
        for _ in range(50):
            inl = torch.abs(r / sigma) <= epsilon
            # f(sigma) = n*sigma + sum_inl r^2/sigma + sum_out (2 eps |r| - eps^2 sigma)
            # df/dsigma = n - sum_inl r^2/sigma^2 - eps^2 * n_out
            n_out, s2 = torch.stack([(~inl).sum().to(torch.float64),
                                     torch.where(inl, r2, 0.0).sum()]).tolist()
            df = n - s2 / (sigma * sigma) - epsilon * epsilon * n_out
            d2f = 2.0 * s2 / (sigma ** 3)
            if d2f <= 0:
                break
            step = df / d2f
            sigma_new = max(sigma - step, 1e-10)
            if abs(sigma_new - sigma) < 1e-12 * max(sigma, 1.0):
                sigma = sigma_new
                break
            sigma = sigma_new

        w, c = w_new, c_new
        new_obj = _objective(X, y, w, c, sigma, epsilon, alpha)
        if abs(obj - new_obj) <= tol * max(abs(obj), 1.0):
            obj = new_obj
            break
        obj = new_obj

    beta = torch.cat([w, c.reshape(1)]).cpu().numpy()
    return HuberFit(coef=beta[:d].copy(), intercept=float(beta[d]), sigma=float(sigma),
                    n_iter=it + 1)


@dataclasses.dataclass
class HuberPolyPipeline:
    """StandardScaler -> PolynomialFeatures -> Huber, as plain arrays
    (the trainer-side twin of calib.temp_weights.TempModelWeights)."""
    scaler_mean: np.ndarray
    scaler_scale: np.ndarray
    powers: np.ndarray
    fit_: HuberFit
    degree: int

    def predict(self, X: np.ndarray) -> np.ndarray:
        Xs = (np.asarray(X, np.float64) - self.scaler_mean) / self.scaler_scale
        P = np.prod(Xs[:, None, :] ** self.powers[None, :, :], axis=-1)
        return P @ self.fit_.coef + self.fit_.intercept


def poly_features(Xs: torch.Tensor, powers: np.ndarray) -> torch.Tensor:
    """(n, P) monomials of the scaled features: each term the product of its
    features' powers in feature order, as ``np.prod`` over the last axis of
    ``Xs[:, None, :] ** powers``, one term at a time."""
    cols = []
    for row in powers:
        t = Xs[:, 0] ** int(row[0])
        for f in range(1, Xs.shape[1]):
            t = t * Xs[:, f] ** int(row[f])
        cols.append(t)
    return torch.stack(cols, dim=1)


def fit_huber_poly(X, y, degree: int, epsilon: float, alpha: float,
                   max_iter: int = 10000, *, device="cuda") -> HuberPolyPipeline:
    """The reference's make_huber_poly_model pipeline
    (``temperature_color_model.py:333-342``), trained with our solver on
    ``device`` (the card unless the caller names another; a CUDA device
    without a card raises).  ``X`` and ``y`` are numpy arrays or tensors."""
    X = torch.as_tensor(X, dtype=torch.float64, device=device)
    y = torch.as_tensor(y, dtype=torch.float64, device=device)
    mean = X.mean(dim=0)
    std = X.std(dim=0, correction=0)
    std = torch.where(std < 1e-12, 1.0, std)
    Xs = (X - mean) / std
    powers = poly_powers(X.shape[1], degree).astype(np.int64)
    fit = huber_fit(poly_features(Xs, powers), y, epsilon=epsilon, alpha=alpha,
                    max_iter=min(max_iter, 500))
    return HuberPolyPipeline(mean.cpu().numpy(), std.cpu().numpy(), powers, fit, degree)
