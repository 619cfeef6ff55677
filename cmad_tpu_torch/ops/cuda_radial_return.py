"""Wrappers of the CUDA J2+Voce radial-return kernels.

Counterpart of ``cmad_tpu/ops/pallas_radial_return.py``. Four kernels
(``csrc/j2_radial_return.cu``) replace its eight ``pallas_call`` sites:

- :func:`soa_step_scalars_cuda` — ``j2_soa_step``, one rate-form step
  (replaces K1 ``_kernel_soa``; K6 ``_kernel_soa_wide`` is the same call
  on the :func:`_to_wide` view);
- :func:`soa_history_cuda` — ``j2_soa_history``, a whole strain history
  of any length T with the state in registers (replaces K2
  ``_kernel_soa_hist_full`` and K3 ``_kernel_soa_hist``; K7 and K8 are
  the same call on the wide view);
- :func:`aos_step_cuda` — ``j2_aos_step``, one rate-form step on the AoS
  state ``(N, 7)`` and displacement gradients ``(N, 3, 3)`` (replaces K4
  ``_kernel``);
- :func:`total_step_cuda` — ``j2_total_step``, one total-form step
  (replaces K5 ``_kernel_total``).

The plain versions are ``ops/j2_radial_return.soa_step_scalars`` (and a
loop of it), ``make_j2_radial_return`` and ``make_j2_radial_return_total``.
These wrappers take CUDA tensors only and raise on anything else; the
dispatching functions (``ops/return_map.py``, ``ops/j2_soa_ad.py``) pick
the plain version for CPU tensors. The AoS wrappers are forward-only, like
the TPU's: an input that requires grad raises (differentiate through the
generic Newton, ``make_batched_return_map(model)``, instead).

Each wrapper adds one to its module-level launch count where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.ops.j2_radial_return import j2_voce_scalars
from cmad_tpu_torch.typing import Tensor

j2_soa_step_launches = 0
j2_soa_history_launches = 0
j2_aos_step_launches = 0
j2_total_step_launches = 0

_SUB = 8  # rows per component in the wide layout
_DTYPES = (torch.float32, torch.float64)


def reset_launch_counts() -> None:
    global j2_soa_step_launches, j2_soa_history_launches
    global j2_aos_step_launches, j2_total_step_launches
    j2_soa_step_launches = 0
    j2_soa_history_launches = 0
    j2_aos_step_launches = 0
    j2_total_step_launches = 0


def launch_counts() -> dict[str, int]:
    return {"j2_soa_step": j2_soa_step_launches,
            "j2_soa_history": j2_soa_history_launches,
            "j2_aos_step": j2_aos_step_launches,
            "j2_total_step": j2_total_step_launches}


def on_cuda(t: Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; any other device
    raises (the port has a kernel for CUDA and a plain version for the
    CPU, and picks nothing else)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no J2 return map for device {t.device}")


def _check(name: str, t: Tensor, shape: tuple[int, ...],
           like: Tensor) -> None:
    if not isinstance(t, Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors; "
                         f"got device {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype must be float32 or float64; "
                        f"got {t.dtype}")
    if t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{name}: {t.dtype} on {t.device} does not match "
                         f"the state's {like.dtype} on {like.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}; "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_state(xi_soa: Tensor) -> int:
    if not isinstance(xi_soa, Tensor) or xi_soa.dim() != 2 \
            or xi_soa.shape[0] != 8:
        shape = getattr(xi_soa, "shape", None)
        raise ValueError(f"xi_soa: expected shape (8, N); got {shape}")
    n = int(xi_soa.shape[1])
    _check("xi_soa", xi_soa, (8, n), xi_soa)
    return n


def _raise_on_error(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.j2_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")


def soa_step_scalars_cuda(xi_soa: Tensor, de_soa: Tensor,
                          scalars: Tensor) -> Tensor:
    """One rate-form radial return on the card: ``xi (8, N), de (8, N),
    scalars (5,) -> xi' (8, N)``, row 7 of the output zero. All three on
    one CUDA device in one dtype (float32 or float64), contiguous.
    Semantics of ``j2_radial_return.soa_step_scalars``."""
    from cmad_tpu_torch.ops._build import load_library

    global j2_soa_step_launches
    n = _check_state(xi_soa)
    _check("de_soa", de_soa, (8, n), xi_soa)
    _check("scalars", scalars, (5,), xi_soa)
    lib = load_library()
    fn = lib.j2_soa_step_f64 if xi_soa.dtype == torch.float64 \
        else lib.j2_soa_step_f32
    out = torch.empty_like(xi_soa)
    if n == 0:
        return out
    with torch.cuda.device(xi_soa.device):
        stream = torch.cuda.current_stream(xi_soa.device).cuda_stream
        rc = fn(xi_soa.data_ptr(), de_soa.data_ptr(), scalars.data_ptr(),
                out.data_ptr(), n, stream)
    _raise_on_error(lib, rc, "j2_soa_step")
    j2_soa_step_launches += 1
    return out


def soa_history_cuda(xi_soa: Tensor, de_hist: Tensor,
                     scalars: Tensor) -> Tensor:
    """The whole strain history in one launch: ``xi (8, N), de_hist
    (T, 8, N), scalars (5,) -> xi' (8, N)`` for any T >= 0, the state in
    registers throughout; only strain rows 0-5 are read. Row 7 of the
    output is zero. Equals T chained :func:`soa_step_scalars_cuda`
    calls up to rounding."""
    from cmad_tpu_torch.ops._build import load_library

    global j2_soa_history_launches
    n = _check_state(xi_soa)
    if not isinstance(de_hist, Tensor) or de_hist.dim() != 3:
        raise ValueError(f"de_hist: expected shape (T, 8, {n}); "
                         f"got {getattr(de_hist, 'shape', None)}")
    t_steps = int(de_hist.shape[0])
    _check("de_hist", de_hist, (t_steps, 8, n), xi_soa)
    _check("scalars", scalars, (5,), xi_soa)
    lib = load_library()
    fn = lib.j2_soa_history_f64 if xi_soa.dtype == torch.float64 \
        else lib.j2_soa_history_f32
    out = torch.empty_like(xi_soa)
    if n == 0:
        return out
    with torch.cuda.device(xi_soa.device):
        stream = torch.cuda.current_stream(xi_soa.device).cuda_stream
        rc = fn(xi_soa.data_ptr(), de_hist.data_ptr(), scalars.data_ptr(),
                out.data_ptr(), n, t_steps, stream)
    _raise_on_error(lib, rc, "j2_soa_history")
    j2_soa_history_launches += 1
    return out


def _check_aos(xi_prev: Tensor, grads: dict[str, Tensor],
               scalars: Tensor) -> int:
    """Validate the AoS inputs; returns N. Forward-only: any input that
    requires grad raises rather than returning a detached result."""
    inputs = {"xi_prev": xi_prev, **grads, "scalars": scalars}
    for name, t in inputs.items():
        if isinstance(t, Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{name} requires grad, but the CUDA J2 return map is "
                f"forward-only; differentiate through the generic Newton "
                f"(make_batched_return_map(model)) instead")
    if not isinstance(xi_prev, Tensor) or xi_prev.dim() != 2 \
            or xi_prev.shape[1] != 7:
        raise ValueError(f"xi_prev: expected shape (N, 7); got "
                         f"{getattr(xi_prev, 'shape', None)}")
    n = int(xi_prev.shape[0])
    _check("xi_prev", xi_prev, (n, 7), xi_prev)
    for name, g in grads.items():
        _check(name, g, (n, 3, 3), xi_prev)
    _check("scalars", scalars, (5,), xi_prev)
    return n


def aos_step_cuda(xi_prev: Tensor, grad_u: Tensor, grad_u_prev: Tensor,
                  scalars: Tensor) -> tuple[Tensor, Tensor]:
    """One rate-form radial return on the AoS state: ``xi_prev (N, 7),
    grad_u, grad_u_prev (N, 3, 3), scalars (5,) -> (xi (N, 7),
    sigma (N, 3, 3))``, all on one CUDA device in one dtype, contiguous.
    Semantics of ``j2_radial_return.make_j2_radial_return``."""
    from cmad_tpu_torch.ops._build import load_library

    global j2_aos_step_launches
    n = _check_aos(xi_prev, {"grad_u": grad_u, "grad_u_prev": grad_u_prev},
                   scalars)
    lib = load_library()
    fn = lib.j2_aos_step_f64 if xi_prev.dtype == torch.float64 \
        else lib.j2_aos_step_f32
    xi = torch.empty_like(xi_prev)
    sigma = torch.empty_like(grad_u)
    if n == 0:
        return xi, sigma
    with torch.cuda.device(xi_prev.device):
        stream = torch.cuda.current_stream(xi_prev.device).cuda_stream
        rc = fn(xi_prev.data_ptr(), grad_u.data_ptr(), grad_u_prev.data_ptr(),
                scalars.data_ptr(), xi.data_ptr(), sigma.data_ptr(), n,
                stream)
    _raise_on_error(lib, rc, "j2_aos_step")
    j2_aos_step_launches += 1
    return xi, sigma


def total_step_cuda(xi_prev: Tensor, grad_u: Tensor,
                    scalars: Tensor) -> tuple[Tensor, Tensor]:
    """One total-form radial return: ``xi_prev (N, 7) = [plastic strain
    (6), alpha], grad_u (N, 3, 3), scalars (5,) -> (xi (N, 7),
    sigma (N, 3, 3))``. Semantics of
    ``j2_radial_return.make_j2_radial_return_total``."""
    from cmad_tpu_torch.ops._build import load_library

    global j2_total_step_launches
    n = _check_aos(xi_prev, {"grad_u": grad_u}, scalars)
    lib = load_library()
    fn = lib.j2_total_step_f64 if xi_prev.dtype == torch.float64 \
        else lib.j2_total_step_f32
    xi = torch.empty_like(xi_prev)
    sigma = torch.empty_like(grad_u)
    if n == 0:
        return xi, sigma
    with torch.cuda.device(xi_prev.device):
        stream = torch.cuda.current_stream(xi_prev.device).cuda_stream
        rc = fn(xi_prev.data_ptr(), grad_u.data_ptr(), scalars.data_ptr(),
                xi.data_ptr(), sigma.data_ptr(), n, stream)
    _raise_on_error(lib, rc, "j2_total_step")
    j2_total_step_launches += 1
    return xi, sigma


def make_cuda_j2_radial_return(parameters):
    """``step(xi_prev, grad_u, grad_u_prev, params) -> (xi, sigma)`` on
    the ``j2_aos_step`` kernel; counterpart of the JAX package's
    ``make_pallas_j2_radial_return`` (same contract as
    ``make_j2_radial_return``). CUDA tensors only."""
    del parameters  # layout fixed by the J2+Voce model

    def step(xi_prev: Tensor, grad_u: Tensor, grad_u_prev: Tensor,
             params) -> tuple[Tensor, Tensor]:
        return aos_step_cuda(xi_prev, grad_u, grad_u_prev,
                             j2_voce_scalars(params, xi_prev.dtype))

    return step


def make_cuda_j2_radial_return_total(parameters):
    """``step(xi_prev, grad_u, grad_u_prev, params) -> (xi, sigma)`` on
    the ``j2_total_step`` kernel (``grad_u_prev`` unused, as in the total
    form); counterpart of ``make_pallas_j2_radial_return_total``. CUDA
    tensors only."""
    del parameters

    def step(xi_prev: Tensor, grad_u: Tensor, grad_u_prev: Tensor,
             params) -> tuple[Tensor, Tensor]:
        del grad_u_prev
        return total_step_cuda(xi_prev, grad_u,
                               j2_voce_scalars(params, xi_prev.dtype))

    return step


def _to_wide(a: Tensor) -> Tensor:
    """(..., 8, N) component-major -> (..., 64, N/8) wide. Row-major
    memory makes these the same bytes (point j of component c sits at
    c*N + j on both sides), so for a contiguous input this is a view:
    the TPU's wide kernels K6-K8 are the narrow kernels on this view."""
    *lead, r, n = a.shape
    if n % _SUB:
        raise ValueError(f"wide layout needs N divisible by {_SUB}; got {n}")
    return a.reshape(*lead, r * _SUB, n // _SUB)


def _from_wide(a: Tensor) -> Tensor:
    *lead, r, w = a.shape
    if r % _SUB:
        raise ValueError(f"wide layout needs rows divisible by {_SUB}; "
                         f"got {r}")
    return a.reshape(*lead, r // _SUB, w * _SUB)
