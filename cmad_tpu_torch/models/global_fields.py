"""Global-field context passed into model evaluation.

Port of ``cmad_tpu/models/global_fields.py`` (parity: reference
``cmad/models/global_fields.py:14,34``). The JAX package registered the
dataclass as a pytree node so that ``jit``/``vmap`` see its leaves; here
it is registered with ``torch.utils._pytree``, which ``torch.func``'s
``vmap``, ``jacfwd`` and ``jacrev`` use to flatten their arguments, so
``in_dims``/``argnums`` reach the tensors inside (``Model.jac_u``,
``make_batched_return_map``). :func:`mp_U_from_F` builds a material
point's U from its deformation gradient.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils._pytree as pytree

from cmad_tpu_torch.typing import Tensor


@dataclass(frozen=True)
class GlobalFieldsAtPoint:
    """Interpolated global fields and gradients at one evaluation point.

    For batched evaluation the leaves carry leading batch dims
    (``fields["u"]: (..., d)``, ``grad_fields["u"]: (..., d, d)``).
    """

    fields: dict[str, Tensor]
    grad_fields: dict[str, Tensor]


pytree.register_pytree_node(
    GlobalFieldsAtPoint,
    lambda g: ((g.fields, g.grad_fields), None),
    lambda children, _ctx: GlobalFieldsAtPoint(*children),
    serialized_type_name="cmad_tpu_torch.GlobalFieldsAtPoint")


def mp_U_from_F(F: Tensor) -> GlobalFieldsAtPoint:
    """Material-point U from a prescribed deformation gradient:
    ``grad u = F - I`` and ``u = 0``, with F's batch dims
    (``(..., d, d)``), on F's device and in F's dtype. Parity: reference
    ``cmad/models/global_fields.py:34``."""
    ndims = F.shape[-1]
    return GlobalFieldsAtPoint(
        fields={"u": torch.zeros((*F.shape[:-2], ndims), dtype=F.dtype,
                                 device=F.device)},
        grad_fields={"u": F - torch.eye(ndims, dtype=F.dtype,
                                        device=F.device)},
    )
