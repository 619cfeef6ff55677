"""Quadrature rules on reference elements.

Port of ``cmad_tpu/fem/quadrature.py`` (numpy and scipy only; parity:
reference ``cmad/fem/quadrature.py``), with its one design change: the
simplex rules are *generated* by collapsed (Duffy) Gauss-Jacobi tensor
products rather than transcribed Keast/Dunavant tables — arbitrary
degree, all-positive weights, exact to the requested total degree. The
side rules (quad and triangle) integrate surface fluxes
(``fem/neumann.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.special import roots_jacobi, roots_legendre

from cmad_tpu_torch.fem.topology import ElementFamily


@dataclass(frozen=True)
class QuadratureRule:
    """Reference-element rule: ``xi (npts, ref_dim)``, ``w (npts,)``.

    Static numpy configuration — never traced.
    """

    xi: np.ndarray
    w: np.ndarray

    @property
    def num_points(self) -> int:
        return int(self.w.shape[0])


def gauss_legendre_1d(n: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = roots_legendre(n)
    return np.asarray(x), np.asarray(w)


def _npts_for(degree: int) -> int:
    if degree < 1:
        raise ValueError(f"quadrature degree must be >= 1; got {degree}")
    return int(np.ceil((degree + 1) / 2))


def hex_quadrature(degree: int) -> QuadratureRule:
    """GL tensor product on [-1,1]^3 (per-coordinate exactness)."""
    n = _npts_for(degree)
    x, w = gauss_legendre_1d(n)
    xi = np.stack(np.meshgrid(x, x, x, indexing="ij"), axis=-1).reshape(-1, 3)
    wts = (w[:, None, None] * w[None, :, None] * w[None, None, :]).ravel()
    return QuadratureRule(xi=xi, w=wts)


def quad_quadrature(degree: int) -> QuadratureRule:
    """GL tensor product on [-1,1]^2."""
    n = _npts_for(degree)
    x, w = gauss_legendre_1d(n)
    xi = np.stack(np.meshgrid(x, x, indexing="ij"), axis=-1).reshape(-1, 2)
    wts = (w[:, None] * w[None, :]).ravel()
    return QuadratureRule(xi=xi, w=wts)


def _shift01(x, w):
    """GL nodes/weights mapped from [-1,1] to [0,1]."""
    return 0.5 * (x + 1.0), 0.5 * w


def tri_quadrature(degree: int) -> QuadratureRule:
    """Collapsed Gauss-Jacobi rule on the unit triangle.

    Duffy map ``x = a (1 - b), y = b`` with Jacobian ``(1 - b)``:
    Gauss-Legendre in ``a``, Gauss-Jacobi(alpha=1, beta=0) in ``b``
    absorbs the Jacobian exactly. Total-degree exact; all weights
    positive; weights sum to 1/2.
    """
    n = _npts_for(degree)
    xa, wa = _shift01(*gauss_legendre_1d(n))
    xb_raw, wb_raw = roots_jacobi(n, 1.0, 0.0)
    # map Jacobi weight (1-t)^1 on [-1,1] to (1-b) on [0,1]: scale 1/4
    xb = 0.5 * (xb_raw + 1.0)
    wb = 0.25 * wb_raw

    A, B = np.meshgrid(xa, xb, indexing="ij")
    WA, WB = np.meshgrid(wa, wb, indexing="ij")
    x = (A * (1.0 - B)).ravel()
    y = B.ravel()
    w = (WA * WB).ravel()
    return QuadratureRule(xi=np.stack([x, y], axis=1), w=w)


def tet_quadrature(degree: int) -> QuadratureRule:
    """Collapsed Gauss-Jacobi rule on the unit tetrahedron.

    Duffy map ``x = a (1-b)(1-c), y = b (1-c), z = c`` with Jacobian
    ``(1-b)(1-c)^2``: GL in ``a``, GJ(1,0) in ``b``, GJ(2,0) in ``c``.
    All-positive weights summing to 1/6.
    """
    n = _npts_for(degree)
    xa, wa = _shift01(*gauss_legendre_1d(n))
    xb_raw, wb_raw = roots_jacobi(n, 1.0, 0.0)
    xb, wb = 0.5 * (xb_raw + 1.0), 0.25 * wb_raw
    xc_raw, wc_raw = roots_jacobi(n, 2.0, 0.0)
    xc, wc = 0.5 * (xc_raw + 1.0), 0.125 * wc_raw

    A, B, C = np.meshgrid(xa, xb, xc, indexing="ij")
    WA, WB, WC = np.meshgrid(wa, wb, wc, indexing="ij")
    x = (A * (1.0 - B) * (1.0 - C)).ravel()
    y = (B * (1.0 - C)).ravel()
    z = C.ravel()
    w = (WA * WB * WC).ravel()
    return QuadratureRule(xi=np.stack([x, y, z], axis=1), w=w)


def default_assembly_quadrature() -> dict[ElementFamily, QuadratureRule]:
    return {ElementFamily.HEX_LINEAR: hex_quadrature(2),
            ElementFamily.TET_LINEAR: tet_quadrature(1)}


def default_side_quadrature() -> dict[ElementFamily, QuadratureRule]:
    return {ElementFamily.HEX_LINEAR: quad_quadrature(2),
            ElementFamily.TET_LINEAR: tri_quadrature(2)}
