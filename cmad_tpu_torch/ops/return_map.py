"""Batched return maps: the material-point models' and the
component-major J2+Voce ones.

Port of ``cmad_tpu/ops/return_map.py``. The JAX package chose its kernel
from ``jax.default_backend()`` when the function was built; here the
choice is made at call time from the device of the input tensors: a CUDA
tensor goes through the CUDA kernels (``ops/cuda_radial_return.py``) or
the call raises, a CPU tensor goes through the plain version
(``ops/j2_radial_return.py``). Any other device raises.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from cmad_tpu_torch.models.deformation_types import DefType
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.models.nonlinear_solver import make_newton_solve
from cmad_tpu_torch.ops.cuda_radial_return import (
    _from_wide,
    _to_wide,
    make_cuda_j2_radial_return,
    make_cuda_j2_radial_return_total,
    on_cuda,
    soa_history_cuda,
    soa_step_scalars_cuda,
)
from cmad_tpu_torch.ops.hill_return import (
    hill_reducible,
    make_hill_local_solve,
)
from cmad_tpu_torch.ops.hosford_return import (
    hosford_reducible,
    make_hosford_local_solve,
)
from cmad_tpu_torch.ops.j2_radial_return import (
    j2_voce_scalars,
    make_j2_radial_return,
    make_j2_radial_return_total,
    soa_step_scalars,
)
from cmad_tpu_torch.ops.principal_return import (
    make_principal_hosford_local_solve,
    principal_hosford_reducible,
)
from cmad_tpu_torch.typing import Tensor


def elastic_plastic_kind(model, effective_stress: str,
                         any_rotation: bool = False) -> str | None:
    """``"rate"`` / ``"total"`` when ``model`` is a small-strain
    elastic-plastic model with the default constitutive funs, FULL_3D,
    an initial yield, the effective stress ``effective_stress`` alone and
    the identity material rotation (any rotation with ``any_rotation``:
    the principal-Hosford and Hill reductions run in the material frame);
    ``None`` otherwise. Without ``any_rotation`` the rotation must be the
    identity when a map is built: specialization keys on build-time
    structure. Reads the rotation to the host once, here, never per
    call."""
    from cmad_tpu_torch.models.small_elastic_plastic import (
        SmallElasticPlastic,
    )
    from cmad_tpu_torch.models.small_rate_elastic_plastic import (
        SmallRateElasticPlastic,
    )
    if type(model) is SmallRateElasticPlastic:
        kind = "rate"
    elif type(model) is SmallElasticPlastic:
        kind = "total"
    else:
        return None
    if not getattr(model, "_uses_default_funs", False):
        return None
    if model._def_type != DefType.FULL_3D:
        return None
    vals = model.parameters.values
    try:
        plastic = vals["plastic"]
        if set(plastic["effective stress"]) != {effective_stress}:
            return None
        if "initial yield" not in plastic["flow stress"]:
            return None
        if any_rotation:
            return kind
        R = vals["rotation matrix"].detach().cpu().numpy()
        return kind if np.allclose(R, np.eye(3)) else None
    except (KeyError, TypeError, AttributeError):
        return None


def j2_voce_kind(model) -> str | None:
    """``"rate"`` / ``"total"`` when ``model`` is a J2+Voce
    :func:`elastic_plastic_kind` model — the exact cases the analytic
    radial returns reproduce to the Newton tolerance; ``None``
    otherwise."""
    kind = elastic_plastic_kind(model, "J2")
    hardening = (model.parameters.values["plastic"]["flow stress"].get(
        "hardening", {}) if kind else {})
    return kind if set(hardening) == {"voce"} else None


def j2_voce_specializable(model) -> bool:
    return j2_voce_kind(model) is not None


def make_j2_radial_return_for(model, prefer_pallas: bool = True):
    """The analytic radial return matching ``model``'s state layout
    (requires ``j2_voce_specializable(model)``):
    ``step(xi_prev, grad_u, grad_u_prev, params) -> (xi, sigma)``.

    On CUDA tensors the rate form runs the ``j2_aos_step`` kernel and the
    total form the ``j2_total_step`` kernel; on CPU tensors, their plain
    versions. ``prefer_pallas=False`` (the keyword kept from the JAX
    package) selects the plain form on every device, as a per-point
    caller that batches outside needs. The JAX package ran its total
    form in XLA on every backend: on the TPU the kernel's packing
    transposes cost more than they saved, and the CUDA kernel reads the
    AoS rows in place with neither."""
    kind = j2_voce_kind(model)
    if kind == "rate":
        plain = make_j2_radial_return(model.parameters)
        kernel = make_cuda_j2_radial_return(model.parameters)
    elif kind == "total":
        plain = make_j2_radial_return_total(model.parameters)
        kernel = make_cuda_j2_radial_return_total(model.parameters)
    else:
        raise ValueError(
            f"{type(model).__name__} is not radial-return specializable")
    if not prefer_pallas:
        return plain

    def step(xi_prev: Tensor, grad_u: Tensor, grad_u_prev: Tensor, params):
        if on_cuda(xi_prev):
            return kernel(xi_prev, grad_u, grad_u_prev, params)
        return plain(xi_prev, grad_u, grad_u_prev, params)

    return step


def make_batched_return_map(model, max_iters: int = 10,
                            abs_tol: float | None = None,
                            rel_tol: float | None = None,
                            specialize: bool = False):
    """Build ``step(xi_prev, grad_u, grad_u_prev, params) -> (xi, sigma)``
    batched over the leading point axis.

    ``xi_prev``: (N, nxi); ``grad_u``/``grad_u_prev``: (N, 3, 3) current
    and previous displacement gradients; ``params``: the values dict,
    shared by every point. Returns the converged state and Cauchy stress
    per point, on the device of the inputs.

    The generic map is the implicit-function Newton of
    ``models/nonlinear_solver.py`` on ``model.residual_fun``,
    differentiable in ``params`` and the inputs. With
    ``specialize=True``, models recognized by :func:`j2_voce_specializable`
    dispatch to the analytic radial return (the CUDA kernels on CUDA
    tensors; forward-only) instead, and, as differentiable as the generic
    map, diagonal-Hosford models to the reduced 4-dof Newton
    (``ops/hosford_return.py``), principal-Hosford models to the 4-dof
    Newton in the trial eigenbasis (``ops/principal_return.py``) and Hill
    models to the scalar Newton (``ops/hill_return.py``), in that order.
    """
    if specialize and j2_voce_specializable(model):
        return make_j2_radial_return_for(model)
    settings = {"max_iters": max_iters, "abs_tol": abs_tol,
                "rel_tol": rel_tol}
    if specialize and hosford_reducible(model):
        solve = make_hosford_local_solve(model, **settings)
    elif specialize and principal_hosford_reducible(model):
        solve = make_principal_hosford_local_solve(model, **settings)
    elif specialize and hill_reducible(model):
        solve = make_hill_local_solve(model, **settings)
    else:
        solve = make_newton_solve(model.residual_fun, max_iters=max_iters,
                                  abs_tol=abs_tol, rel_tol=rel_tol,
                                  in_dims=(0, None, 0, 0))
    cauchy = vmap(model.cauchy_fun, in_dims=(0, 0, None, 0, 0))

    def step(xi_prev: Tensor, grad_u: Tensor, grad_u_prev: Tensor, params):
        on_cuda(xi_prev)  # any device but the card or the CPU raises
        # GlobalFieldsAtPoint holds the batch here (it is a registered
        # pytree, so vmap's in_dims reach its tensors)
        zeros = grad_u.new_zeros(grad_u.shape[:-1])
        U = GlobalFieldsAtPoint(fields={"u": zeros},
                                grad_fields={"u": grad_u})
        U_prev = GlobalFieldsAtPoint(fields={"u": zeros},
                                     grad_fields={"u": grad_u_prev})
        xi = solve(xi_prev, xi_prev, params, U, U_prev)
        return xi, cauchy(xi, xi_prev, params, U, U_prev)

    return step


def _step_scalars(xi_soa: Tensor, de_soa: Tensor, scalars: Tensor) -> Tensor:
    if on_cuda(xi_soa):
        return soa_step_scalars_cuda(xi_soa, de_soa, scalars)
    return soa_step_scalars(xi_soa, de_soa, scalars)


def make_soa_radial_return(parameters):
    """The component-major (SoA) J2+Voce radial return:
    ``step(xi_soa: (8, N), de_soa: (8, N), params) -> (8, N)``
    (contract in ``ops/j2_radial_return.py``), on the device of its
    inputs: the ``j2_soa_step`` kernel for CUDA tensors, the plain step
    for CPU tensors. ``params`` is a values dict on that device."""
    del parameters  # layout is fixed by the J2+Voce model

    def step(xi_soa: Tensor, de_soa: Tensor, params) -> Tensor:
        scalars = j2_voce_scalars(params, xi_soa.dtype)
        return _step_scalars(xi_soa, de_soa, scalars)

    return step


def make_j2_history_drive(parameters, record_alpha: bool = False,
                          fused: bool | None = None,
                          layout: str = "soa8"):
    """Batched J2+Voce history driver, component-major throughout:
    ``drive(xi0_soa: (8, N), de_hist: (T, 8, N), params)`` applies the
    strain-increment history carrying the (8, N) state. Returns the final
    state, or ``(final, alpha_hist)`` with ``alpha_hist: (T, N)`` when
    ``record_alpha`` (the accumulated plastic strain per step).

    On CUDA tensors the fused drive (``fused`` None or True, and
    ``record_alpha=False``) is ONE ``j2_soa_history`` launch for the
    whole history, any T, with the state in registers; otherwise it is a
    Python loop of ``j2_soa_step`` launches. On CPU tensors it is the
    plain loop of steps — the plain version of both kernels.

    ``layout='wide'`` takes ``xi0 (64, N/8), de_hist (T, 64, N/8)`` —
    the (8, N) arrays viewed as row-major (64, N/8), component c on rows
    [8c, 8c+8) — and returns the final state in that layout. In row-major
    memory the two layouts are the same bytes, so the drive reshapes to
    (8, N) views, runs the same kernel and reshapes back: results are
    bit-identical to soa8. Requires the fused path, as in the JAX
    package."""
    if layout not in ("soa8", "wide"):
        raise ValueError(f"layout must be 'soa8' or 'wide'; got {layout!r}")
    use_fused = fused is not False and not record_alpha
    if layout == "wide" and not use_fused:
        raise ValueError(
            "layout='wide' requires the fused path "
            "(record_alpha=False, fused not disabled)")

    def drive(xi0_soa: Tensor, de_hist: Tensor, params):
        if layout == "wide":
            xi0_soa, de_hist = _from_wide(xi0_soa), _from_wide(de_hist)
        scalars = j2_voce_scalars(params, xi0_soa.dtype)
        if use_fused and on_cuda(xi0_soa):
            xi = soa_history_cuda(xi0_soa, de_hist, scalars)
            return _to_wide(xi) if layout == "wide" else xi

        xi = xi0_soa
        alphas = []
        for t in range(de_hist.shape[0]):
            xi = _step_scalars(xi, de_hist[t], scalars)
            if record_alpha:
                alphas.append(xi[6])
        if record_alpha:
            alpha_hist = (torch.stack(alphas) if alphas
                          else xi.new_empty((0, xi.shape[1])))
            return xi, alpha_hist
        return _to_wide(xi) if layout == "wide" else xi

    return drive
