"""Component-major per-IP state carrier for the FE drive.

Port of ``pack_xi`` / ``unpack_xi`` of ``cmad_tpu/fem/xi_carrier.py``:
the FE dispatch boundary. A drive packs the AoS ``(E, Q, nxi)`` state
once at trajectory entry into the ``(nxi + 1, E*Q)`` carrier that the
SoA return map (``ops/j2_soa_ad.py``) consumes and produces — for the
rate form the kernel's output IS the next step's input — and unpacks it
only where the history is materialized.

Layout contract: carrier row ``c`` holds AoS component ``c`` flattened
over the ``(E, Q)`` point batch in C order; the last row is zero padding
(the kernels' 8th state row). ``unpack(pack(x)) == x`` exactly;
pack/unpack are linear, so autograd flows through them.
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.typing import Tensor


def pack_xi(xi_aos: Tensor) -> Tensor:
    """AoS ``(E, Q, nxi)`` -> component-major ``(nxi + 1, E*Q)`` with a
    zero padding row (the SoA kernel's 8-row state block)."""
    E, Q, nxi = xi_aos.shape
    rows = xi_aos.reshape(E * Q, nxi).T
    return torch.cat([rows, rows.new_zeros((1, E * Q))])


def unpack_xi(xi_carrier: Tensor, E: int, Q: int) -> Tensor:
    """Inverse of :func:`pack_xi`: ``(nxi + 1, E*Q)`` -> ``(E, Q, nxi)``
    (the padding row is dropped)."""
    nxi = xi_carrier.shape[0] - 1
    return xi_carrier[:nxi].T.reshape(E, Q, nxi)
