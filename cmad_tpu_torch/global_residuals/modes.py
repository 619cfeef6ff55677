"""GlobalResidual operating modes.

Port of ``cmad_tpu/global_residuals/modes.py`` (parity: reference
``cmad/global_residuals/modes.py``).
"""
from enum import IntEnum


class GlobalResidualMode(IntEnum):
    COUPLED = 0
    CLOSED_FORM = 1
