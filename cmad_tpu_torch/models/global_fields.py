"""Global-field context passed into model evaluation.

Port of ``cmad_tpu/models/global_fields.py`` (parity: reference
``cmad/models/global_fields.py:14,34``). The JAX package registered the
dataclass as a pytree node so that ``jit``/``vmap`` see its leaves; here
it is registered with ``torch.utils._pytree``, which ``torch.func``'s
``vmap``, ``jacfwd`` and ``jacrev`` use to flatten their arguments, so
``in_dims``/``argnums`` reach the tensors inside (``Model.jac_u``,
``make_batched_return_map``).
"""
from __future__ import annotations

from dataclasses import dataclass

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
