"""Isotropic linear-elastic constant conversions.

Port of ``cmad_tpu/models/elastic_constants.py``. Any two of
``{E, nu, mu, kappa, lambda}`` determine the Lame pair ``(lmbda, mu)``.
The arithmetic works on Python floats and on tensors alike, and is
differentiable so constants can be active calibration parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from cmad_tpu_torch.typing import Scalar

_NAMES = ("E", "nu", "mu", "kappa", "lambda")


def compute_mu(E: Scalar, nu: Scalar) -> Scalar:
    return E / (2.0 * (1.0 + nu))


def compute_kappa(E: Scalar, nu: Scalar) -> Scalar:
    return E / (3.0 * (1.0 - 2.0 * nu))


def compute_lambda(E: Scalar, nu: Scalar) -> Scalar:
    return E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))


@dataclass(frozen=True)
class ElasticConstants:
    """Lame-pair canonical store; everything else derived on demand."""

    lmbda: Scalar
    mu: Scalar

    @property
    def kappa(self) -> Scalar:
        return self.lmbda + 2.0 * self.mu / 3.0

    @property
    def E(self) -> Scalar:
        return self.mu * (3.0 * self.lmbda + 2.0 * self.mu) / (self.lmbda + self.mu)

    @property
    def nu(self) -> Scalar:
        return self.lmbda / (2.0 * (self.lmbda + self.mu))

    @classmethod
    def from_params(cls, elastic: dict[str, Any]) -> "ElasticConstants":
        given = tuple(n for n in _NAMES if n in elastic)
        if len(given) != 2:
            raise ValueError(
                f"need exactly two of {_NAMES}; got {given}"
            )
        g = dict(elastic)
        pair = frozenset(given)

        if pair == frozenset(("lambda", "mu")):
            return cls(g["lambda"], g["mu"])
        if pair == frozenset(("E", "nu")):
            E, nu = g["E"], g["nu"]
            return cls(compute_lambda(E, nu), compute_mu(E, nu))
        if pair == frozenset(("mu", "kappa")):
            mu, kappa = g["mu"], g["kappa"]
            return cls(kappa - 2.0 * mu / 3.0, mu)
        if pair == frozenset(("E", "mu")):
            E, mu = g["E"], g["mu"]
            return cls(mu * (E - 2.0 * mu) / (3.0 * mu - E), mu)
        if pair == frozenset(("E", "kappa")):
            E, kappa = g["E"], g["kappa"]
            mu = 3.0 * kappa * E / (9.0 * kappa - E)
            return cls(3.0 * kappa * (3.0 * kappa - E) / (9.0 * kappa - E), mu)
        if pair == frozenset(("mu", "nu")):
            mu, nu = g["mu"], g["nu"]
            return cls(2.0 * mu * nu / (1.0 - 2.0 * nu), mu)
        if pair == frozenset(("kappa", "nu")):
            kappa, nu = g["kappa"], g["nu"]
            mu = 3.0 * kappa * (1.0 - 2.0 * nu) / (2.0 * (1.0 + nu))
            return cls(3.0 * kappa * nu / (1.0 + nu), mu)
        if pair == frozenset(("lambda", "nu")):
            lmbda, nu = g["lambda"], g["nu"]
            return cls(lmbda, lmbda * (1.0 - 2.0 * nu) / (2.0 * nu))
        if pair == frozenset(("lambda", "kappa")):
            lmbda, kappa = g["lambda"], g["kappa"]
            return cls(lmbda, 3.0 * (kappa - lmbda) / 2.0)
        if pair == frozenset(("E", "lambda")):
            E, lmbda = g["E"], g["lambda"]
            R = (E**2 + 9.0 * lmbda**2 + 2.0 * E * lmbda) ** 0.5
            return cls(lmbda, (E - 3.0 * lmbda + R) / 4.0)
        raise ValueError(f"unsupported elastic-constant pair: {given}")
