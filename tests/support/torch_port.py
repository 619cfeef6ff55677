"""Shared checks for the tests of cmad_tpu_torch against cmad_tpu."""
from __future__ import annotations

import numpy as np
import torch


def assert_rows_close(port_out, ref, rtol=1e-12):
    """Per-row bound ``max|port - ref| <= rtol * max(1, max|ref_row|)``
    on (rows, ...) arrays: the port's tensor against the JAX array."""
    a = np.asarray(port_out.detach() if isinstance(port_out, torch.Tensor)
                   else port_out)
    b = np.asarray(ref)
    assert a.shape == b.shape
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    for r in range(a2.shape[0]):
        scale = max(1.0, float(np.abs(b2[r]).max(initial=0.0)))
        err = float(np.abs(a2[r] - b2[r]).max(initial=0.0))
        assert err <= rtol * scale, f"row {r}: {err} > {rtol} * {scale}"
