"""MCMC convergence diagnostics: rank-normalized split-R-hat, bulk
ESS, and tail ESS.

A numpy/scipy copy of gp_ss_ak_tpu/bayes/diagnostics.py (which imports
no jax), kept here so the port imports nothing of the JAX package.

Implements the Vehtari, Gelman, Simpson, Carpenter, Bürkner (2021)
"Rank-normalization, folding, and localization" recipe over
(chains, samples, p) arrays — the quality gates for the
hyperposterior path (accept-rate alone says nothing about mixing):

- draws are pooled-rank-transformed and mapped through the normal
  quantile function before computing R-hat / bulk ESS, so heavy-tailed
  hyperposteriors (lengthscales, variances) don't overstate ESS;
- R-hat is the max of the rank-normalized split-R-hat and the
  folded (|theta - median|) split-R-hat, catching scale mismixing;
- tail ESS is the minimum ESS of the 5% / 95% exceedance indicators.
"""

from __future__ import annotations

import numpy as np


def _rank_normalize(theta: np.ndarray) -> np.ndarray:
    """Pooled fractional ranks -> normal scores, per parameter.

    theta: (chains, samples, p). Average-rank tie handling (ties get
    identical scores — positional tie-breaking would inject a spurious
    within-tie trend and depress ESS); the fractional offset
    (r - 3/8)/(S + 1/4) is the Blom estimator Vehtari (2021) §3 uses.
    """
    # imported here: scipy.stats takes seconds to import, and every
    # process that imports the port's bayes/ would pay for it
    from scipy.special import ndtri
    from scipy.stats import rankdata

    c, s, p = theta.shape
    flat = theta.reshape(c * s, p)
    n = c * s
    ranks = rankdata(flat, method="average", axis=0)
    z = ndtri((ranks - 3.0 / 8.0) / (n + 1.0 / 4.0))
    return z.reshape(c, s, p)


def _split_rhat_raw(theta: np.ndarray) -> np.ndarray:
    """Classic split-R-hat on the given draws (no transformation)."""
    th = np.asarray(theta, np.float64)
    c, s, p = th.shape
    half = s // 2
    splits = np.concatenate([th[:, :half], th[:, half : 2 * half]], axis=0)
    m, n = splits.shape[0], splits.shape[1]
    chain_means = splits.mean(axis=1)                    # (m, p)
    chain_vars = splits.var(axis=1, ddof=1)              # (m, p)
    B = n * chain_means.var(axis=0, ddof=1)              # (p,)
    W = chain_vars.mean(axis=0)                          # (p,)
    var_plus = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / W)
    return np.where(W > 0, rhat, 1.0)


def split_rhat(theta: np.ndarray, rank_normalized: bool = True
               ) -> np.ndarray:
    """Split-R-hat per parameter; theta: (chains, samples, p).

    With `rank_normalized` (default) this is Vehtari (2021) eq. 4-8:
    max(split-R-hat of the rank-normal scores, split-R-hat of the
    rank-normal scores of the FOLDED draws |theta - median|)."""
    th = np.asarray(theta, np.float64)
    if not rank_normalized:
        return _split_rhat_raw(th)
    bulk = _split_rhat_raw(_rank_normalize(th))
    folded = np.abs(th - np.median(th.reshape(-1, th.shape[-1]), axis=0))
    tail = _split_rhat_raw(_rank_normalize(folded))
    return np.maximum(bulk, tail)


def _autocov(x: np.ndarray) -> np.ndarray:
    """Autocovariance by FFT per chain; x: (n,) -> (n,)."""
    n = x.shape[0]
    xc = x - x.mean()
    f = np.fft.rfft(xc, 2 * n)
    acov = np.fft.irfft(f * np.conj(f))[:n].real / n
    return acov


def _ess_raw(theta: np.ndarray) -> np.ndarray:
    """ESS on the given draws (Geyer initial monotone sequence over
    chain-averaged autocorrelations, Vehtari 2021 §3.2)."""
    th = np.asarray(theta, np.float64)
    c, s, p = th.shape
    out = np.zeros(p)
    for j in range(p):
        acovs = np.stack([_autocov(th[i, :, j]) for i in range(c)])
        chain_var = acovs[:, 0].mean()
        if chain_var == 0:
            out[j] = c * s
            continue
        mean_var = th[:, :, j].mean(axis=1).var(ddof=1) if c > 1 else 0.0
        var_plus = (s - 1) / s * chain_var + mean_var
        rho = 1.0 - (chain_var - acovs.mean(axis=0)) / var_plus
        rho[0] = 1.0
        # Geyer pairs: sum while pair sums positive and monotone
        tau = 0.0
        prev = np.inf
        for t in range(0, s - 1, 2):
            pair = rho[t] + (rho[t + 1] if t + 1 < s else 0.0)
            if pair < 0:
                break
            pair = min(pair, prev)
            prev = pair
            tau += pair
        tau = max(2.0 * tau - 1.0, 1.0 / s)
        out[j] = c * s / tau
    return np.minimum(out, c * s)


def ess_bulk(theta: np.ndarray) -> np.ndarray:
    """Bulk effective sample size per parameter, computed on the
    rank-normalized draws (Vehtari 2021 §4.1) so heavy tails don't
    inflate the estimate."""
    th = np.asarray(theta, np.float64)
    return _ess_raw(_rank_normalize(th))


def ess_tail(theta: np.ndarray) -> np.ndarray:
    """Tail effective sample size: min ESS of the 5% and 95%
    exceedance indicators (Vehtari 2021 §4.3) — the resolution of the
    chains in the distribution tails, which bulk ESS can't see."""
    th = np.asarray(theta, np.float64)
    c, s, p = th.shape
    flat = th.reshape(c * s, p)
    q05 = np.quantile(flat, 0.05, axis=0)
    q95 = np.quantile(flat, 0.95, axis=0)
    # the 0/1 indicators are already scale-free — ESS is computed on
    # them directly (rank-normalizing a binary series is a no-op up to
    # the two tie groups)
    ess05 = _ess_raw((th <= q05).astype(np.float64))
    ess95 = _ess_raw((th >= q95).astype(np.float64))
    return np.minimum(ess05, ess95)


def summarize(theta: np.ndarray, names=None) -> dict:
    """{'rhat', 'ess', 'ess_tail', 'mean', 'std', 'names'} arrays."""
    th = np.asarray(theta, np.float64)
    flat = th.reshape(-1, th.shape[-1])
    return {
        "rhat": split_rhat(th),
        "ess": ess_bulk(th),
        "ess_tail": ess_tail(th),
        "mean": flat.mean(axis=0),
        "std": flat.std(axis=0, ddof=1),
        "names": list(names) if names is not None else None,
    }
