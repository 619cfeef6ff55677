"""Derivative seed indices (argument positions of model functions).

Port of ``cmad_tpu/models/deriv_types.py`` (parity: reference
``cmad/models/deriv_types.py:4``).
"""
from enum import IntEnum


class DerivType(IntEnum):
    DXI = 0
    DXI_PREV = 1
    DPARAMS = 2
    DU = 3
    DU_PREV = 4
    DNONE = 5
