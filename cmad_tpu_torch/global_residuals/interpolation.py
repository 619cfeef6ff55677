"""Element-coefficient -> integration-point interpolation.

Port of ``cmad_tpu/global_residuals/interpolation.py`` (parity:
reference ``cmad/global_residuals/interpolation.py``). Per residual
block, so mixed-basis formulations compose; same-basis multi-field
problems pass identical shape entries. Written for one point; the
generic FE block (``fem/generic_block.py``) and the postprocessing
batch it with ``torch.func.vmap``.
"""
from __future__ import annotations

from collections.abc import Sequence

from cmad_tpu_torch.fem.elements import ShapeFunctionsAtIP
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.typing import Tensor


def interpolate_global_fields_at_ip(
        U: Sequence[Tensor],
        shapes_ip: Sequence[ShapeFunctionsAtIP],
        var_names: Sequence[str]) -> GlobalFieldsAtPoint:
    """fields[name] = N @ U_i  (num_eqs,);
    grad_fields[name] = U_i^T @ grad_N  (num_eqs, ndims)."""
    if any(n is None for n in var_names):
        raise ValueError(
            "all var_names must be populated before interpolation")
    fields, grads = {}, {}
    for name, U_i, s in zip(var_names, U, shapes_ip, strict=True):
        fields[name] = s.N @ U_i
        grads[name] = U_i.mT @ s.grad_N
    return GlobalFieldsAtPoint(fields=fields, grad_fields=grads)
