"""Closed-form moments of rectified / clipped Gaussians (port of
``dfq_tpu/quant/moments.py``).

Given a pre-activation ``X ~ N(mu, sigma^2)`` (mu/sigma taken from folded
BatchNorm statistics), compute mean and variance of ``ReLU(X)`` and
``clip(X, 0, 6)``. The argument order follows the reference's lambdas
(``sigma`` first, then ``mu``).

Elementwise; numpy inputs run on scipy's ``erf`` (the host passes), torch
tensors on ``torch.special.erf``.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.special as sp_special
import torch

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _backend(x):
    if isinstance(x, torch.Tensor):
        return torch.exp, torch.special.erf
    return np.exp, sp_special.erf


def _phi(x, exp):
    """Standard normal pdf."""
    return _INV_SQRT_2PI * exp(-0.5 * x * x)


def _Phi(x, erf):
    """Standard normal cdf."""
    return 0.5 * (1.0 + erf(x / _SQRT2))


def relu_gaussian_mean(sigma, mu):
    """E[ReLU(X)], X ~ N(mu, sigma^2)."""
    exp, erf = _backend(sigma)
    a = -mu / sigma
    return sigma * _phi(a, exp) + mu * (1.0 - _Phi(a, erf))


def relu_gaussian_var(sigma, mu, mean):
    """E[(ReLU(X) - mean)^2] given precomputed ``mean = E[ReLU(X)]``."""
    exp, erf = _backend(sigma)
    a = -mu / sigma
    cdf_a = _Phi(a, erf)
    return (
        (1.0 - cdf_a) * (mu * mu + sigma * sigma + mean * mean - 2.0 * mean * mu)
        + sigma * (mu - 2.0 * mean) * _phi(a, exp)
        + mean * mean * cdf_a
    )


def relu6_gaussian_mean(sigma, mu, cap: float = 6.0):
    """E[clip(X, 0, cap)], X ~ N(mu, sigma^2)."""
    exp, erf = _backend(sigma)
    a = -mu / sigma
    b = (cap - mu) / sigma
    return (
        sigma * (_phi(a, exp) - _phi(b, exp))
        + mu * (_Phi(b, erf) - _Phi(a, erf))
        + cap * (1.0 - _Phi(b, erf))
    )


def relu6_gaussian_var(sigma, mu, mean, cap: float = 6.0):
    """E[(clip(X,0,cap) - mean)^2] given ``mean = E[clip(X,0,cap)]``."""
    exp, erf = _backend(sigma)
    a = -mu / sigma
    b = (cap - mu) / sigma
    cdf_a = _Phi(a, erf)
    cdf_b = _Phi(b, erf)
    return (
        (cdf_b - cdf_a) * (mu * mu + sigma * sigma + mean * mean - 2.0 * mean * mu)
        + sigma * (-cap) * _phi(b, exp)
        + sigma * (mu - 2.0 * mean) * (_phi(a, exp) - _phi(b, exp))
        + mean * mean * cdf_a
        + (cap - mean) ** 2 * (1.0 - cdf_b)
    )
