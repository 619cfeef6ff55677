"""Material-point inputs shared by the port's MP tests: the round-trip
deck's parameters (``tests/cli/test_mp_roundtrips.py``) and its eps_xx
ramp."""
from __future__ import annotations

import numpy as np


def params_section() -> dict:
    """The round-trip deck's parameters, Y, S and D active (log and
    bounds transforms), with the models' default rotation."""
    return {
        "rotation matrix": np.eye(3).tolist(),
        "elastic": {"E": {"value": 200e3}, "nu": {"value": 0.3}},
        "plastic": {
            "effective stress": {"J2": {"value": 0.0}},
            "flow stress": {
                "initial yield": {
                    "Y": {"value": 200.0, "active": True,
                          "transform": {"log": 200.0}}},
                "hardening": {
                    "voce": {
                        "S": {"value": 200.0, "active": True,
                              "transform": {"bounds": [100.0, 300.0]}},
                        "D": {"value": 20.0, "active": True,
                              "transform": {"bounds": [10.0, 30.0]}}}}}}}


def ramp_F(nd: int, num_steps: int = 6, last: float = 0.015) -> np.ndarray:
    """(nd, nd, num_steps + 1): F_xx - 1 from 0 through 0.0008 to
    ``last`` (through yield), the other entries the identity's."""
    eps = np.r_[0.0, np.linspace(0.0008, last, num_steps)]
    F = np.repeat(np.eye(nd)[:, :, None], num_steps + 1, axis=2)
    F[0, 0, :] += eps
    return F
