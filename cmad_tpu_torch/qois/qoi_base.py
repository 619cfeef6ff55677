"""Marker base class shared by every QoI of the port.

Port of ``cmad_tpu/qois/qoi_base.py`` (parity: reference
``cmad/qois/qoi_base.py:15``). The registry returns this common type and
the caller dispatches on ``problem_type``.
"""
from __future__ import annotations

from typing import ClassVar


class QoIBase:
    problem_type: ClassVar[str]
