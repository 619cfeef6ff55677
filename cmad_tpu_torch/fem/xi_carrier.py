"""Component-major per-IP state carrier for the FE drive.

Port of ``cmad_tpu/fem/xi_carrier.py``: the FE dispatch boundary. A
drive packs the AoS ``(E, Q, nxi)`` state once at trajectory entry into
the ``(nxi + 1, E*Q)`` carrier that the SoA return map
(``ops/j2_soa_ad.py``) consumes and produces — for the rate form the
kernel's output IS the next step's input — and unpacks it only where the
history is materialized (``FEState``). A block opts in with
``"xi_carrier": True`` in its evaluators (``fem/j2_block.py``).

Layout contract: carrier row ``c`` holds AoS component ``c`` flattened
over the ``(E, Q)`` point batch in C order; the last row is zero padding
(the kernels' 8th state row). ``unpack(pack(x)) == x`` exactly;
pack/unpack are linear, so autograd flows through them.

Unlike the JAX package, nothing here infers a layout from ``ndim``:
``(E, Q, nxi)`` AoS and a stacked carrier history ``(T, nxi + 1, E*Q)``
are both 3-D, so :func:`pack_xi_by_block` and
:func:`unpack_xi_by_block` take the layout they are given as an argument
and check every array's shape against the block's ``(E, Q, nxi)``.
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.typing import Tensor

LAYOUTS = ("aos", "carrier")


def pack_xi(xi_aos: Tensor, nxi: int | None = None) -> Tensor:
    """AoS ``(E, Q, nxi)`` -> component-major ``(nxi + 1, E*Q)`` with a
    zero padding row (the SoA kernel's 8-row state block). With ``nxi``
    given, a trailing dimension other than ``nxi`` raises."""
    if xi_aos.dim() != 3 or (nxi is not None and xi_aos.shape[-1] != nxi):
        want = "(E, Q, nxi)" if nxi is None else f"(E, Q, {nxi})"
        raise ValueError(f"pack_xi: expected AoS state {want}; got "
                         f"{tuple(xi_aos.shape)}")
    E, Q, nxi = xi_aos.shape
    rows = xi_aos.reshape(E * Q, nxi).T
    return torch.cat([rows, rows.new_zeros((1, E * Q))])


def unpack_xi(xi_carrier: Tensor, E: int, Q: int) -> Tensor:
    """Inverse of :func:`pack_xi`: ``(nxi + 1, E*Q)`` -> ``(E, Q, nxi)``
    (the padding row is dropped)."""
    nxi = xi_carrier.shape[0] - 1
    return xi_carrier[:nxi].T.reshape(E, Q, nxi)


def carrier_blocks(fe_problem) -> dict[str, tuple[int, int, int]]:
    """``block_name -> (E, Q, nxi)`` for blocks whose evaluators opt into
    the component-major carrier."""
    out: dict[str, tuple[int, int, int]] = {}
    geom = fe_problem.kernel_arrays.geometry_cache
    for b, ev in fe_problem.evaluators_by_block.items():
        if ev.get("xi_carrier"):
            det = geom[b]["per_elem"]["iso_jac_det"]
            out[b] = (int(det.shape[0]), int(det.shape[1]),
                      int(fe_problem.models_by_block[b].num_dofs))
    return out


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}; got {layout!r}")


def _check_shape(b: str, v: Tensor, shape: tuple[int, ...],
                 layout: str) -> None:
    if tuple(v.shape) != shape:
        raise ValueError(f"block {b!r}: {layout} state must have shape "
                         f"{shape}; got {tuple(v.shape)}")


def pack_xi_by_block(fe_problem, xi_by_block, layout: str = "aos"):
    """Every opted-in block's state as a carrier. ``layout`` says what
    ``xi_by_block`` holds: ``"aos"`` (each block ``(E, Q, nxi)``, packed)
    or ``"carrier"`` (each block ``(nxi + 1, E*Q)``, passed through).
    Non-carrier blocks pass through unchanged."""
    _check_layout(layout)
    cb = carrier_blocks(fe_problem)
    out = {}
    for b, v in xi_by_block.items():
        if b not in cb:
            out[b] = v
            continue
        E, Q, nxi = cb[b]
        if layout == "aos":
            _check_shape(b, v, (E, Q, nxi), layout)
            out[b] = pack_xi(v, nxi)
        else:
            _check_shape(b, v, (nxi + 1, E * Q), layout)
            out[b] = v
    return out


def unpack_xi_by_block(fe_problem, xi_by_block):
    """Every opted-in block's carrier state ``(nxi + 1, E*Q)`` back to
    AoS ``(E, Q, nxi)``; non-carrier blocks pass through."""
    cb = carrier_blocks(fe_problem)
    out = {}
    for b, v in xi_by_block.items():
        if b not in cb:
            out[b] = v
            continue
        E, Q, nxi = cb[b]
        _check_shape(b, v, (nxi + 1, E * Q), "carrier")
        out[b] = unpack_xi(v, E, Q)
    return out
