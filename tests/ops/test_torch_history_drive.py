"""cmad_tpu_torch's history drive against cmad_tpu's, and the chip smoke
script's refusal to run without a GPU.

The JAX drive runs its Pallas history kernels K2 + K3 in interpret mode
(``fused=True``, T = 11: one chunk of 8 plus a remainder of 3) and its
``lax.scan`` of XLA steps (``fused=False``); on CPU tensors the port runs
its plain loop of steps. Same numpy inputs, float64, per-row tolerance
``1e-12 * max(1, max|ref_row|)``.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.ops.return_map import make_j2_history_drive as jax_drive
from cmad_tpu_torch.ops.cuda_radial_return import _from_wide, _to_wide
from cmad_tpu_torch.ops.return_map import (
    make_j2_history_drive,
    make_soa_radial_return,
)
from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

from tests.support.problems import J2AnalyticalProblem
from tests.support.torch_port import assert_rows_close

torch.set_num_threads(1)

F64 = torch.float64
N, T = 333, 11
REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def case():
    p = J2AnalyticalProblem().J2_parameters
    tp = parameters_from_numpy(jax.tree.map(np.asarray, p.values),
                               dtype=F64, device="cpu")
    rng = np.random.default_rng(7)
    xi0 = np.zeros((8, N))
    xi0[:6] = rng.normal(0.0, 30.0, size=(6, N))
    de = np.zeros((T, 8, N))
    de[:, :6] = rng.normal(0.0, 1.0e-4, size=(T, 6, N))
    return p, tp, xi0, de


@pytest.fixture(scope="module")
def port_final(case):
    _p, tp, xi0, de = case
    return make_j2_history_drive(tp)(torch.tensor(xi0), torch.tensor(de),
                                     tp.values)


def test_drive_matches_jax_fused_pallas_k2_k3(case, port_final):
    p, _tp, xi0, de = case
    ref = jax_drive(p, fused=True)(jnp.asarray(xi0), jnp.asarray(de),
                                   p.values)
    frac = float(np.mean(port_final[6].numpy() > 0))
    assert 0.2 <= frac <= 0.8, frac
    assert_rows_close(port_final, ref)


def test_drive_matches_jax_unfused_scan(case, port_final):
    p, _tp, xi0, de = case
    ref = jax_drive(p, fused=False)(jnp.asarray(xi0), jnp.asarray(de),
                                    p.values)
    assert_rows_close(port_final, ref)


def test_record_alpha_matches_jax(case, port_final):
    p, tp, xi0, de = case
    ref, ref_alpha = jax_drive(p, record_alpha=True)(
        jnp.asarray(xi0), jnp.asarray(de), p.values)
    final, alpha = make_j2_history_drive(tp, record_alpha=True)(
        torch.tensor(xi0), torch.tensor(de), tp.values)
    assert alpha.shape == (T, N)
    assert_rows_close(final, ref)
    assert_rows_close(alpha, ref_alpha)
    assert torch.equal(final, port_final)


def test_drive_equals_stepwise_port(case, port_final):
    """The drive on CPU is the plain loop of the SoA step, bit for bit,
    fused or not."""
    _p, tp, xi0, de = case
    step = make_soa_radial_return(tp)
    xi = torch.tensor(xi0)
    for t in range(T):
        xi = step(xi, torch.tensor(de[t]), tp.values)
    assert torch.equal(xi, port_final)
    unfused = make_j2_history_drive(tp, fused=False)(
        torch.tensor(xi0), torch.tensor(de), tp.values)
    assert torch.equal(unfused, port_final)


def test_wide_layout_bit_identical_to_soa8(case):
    """``layout='wide'`` takes the (64, N/8) view of the same bytes and
    gives the soa8 result, bit for bit."""
    _p, tp, xi0, de = case
    n8 = N - N % 8
    x = torch.tensor(xi0[:, :n8])
    d = torch.tensor(de[:, :, :n8])
    soa8 = make_j2_history_drive(tp)(x, d, tp.values)
    wide = make_j2_history_drive(tp, layout="wide")(
        _to_wide(x), _to_wide(d), tp.values)
    assert wide.shape == (64, n8 // 8)
    assert torch.equal(_from_wide(wide), soa8)


@pytest.fixture(scope="module")
def jax_scan_drive(case):
    """The JAX drive's ``lax.scan`` path (one jitted function; each shape
    below compiles once)."""
    p = case[0]
    return jax_drive(p, fused=False)


@pytest.mark.parametrize("n", [1, 33])
@pytest.mark.parametrize("t_steps", [0, 1, 2])
def test_plain_drive_edges_match_jax_scan(case, jax_scan_drive, n, t_steps):
    """The plain history drive at the shortest histories and smallest
    batches that the kernel's edge cases exercise on the card: T = 0
    returns the initial state, as the JAX scan does."""
    p, tp, _xi0, _de = case
    rng = np.random.default_rng(100 + 10 * n + t_steps)
    xi0 = np.zeros((8, n))
    xi0[:6] = rng.normal(0.0, 30.0, size=(6, n))
    xi0[6] = np.abs(rng.normal(0.0, 0.005, size=n))
    de = np.zeros((t_steps, 8, n))
    de[:, :6] = rng.normal(0.0, 0.4e-3, size=(t_steps, 6, n))
    ref = jax_scan_drive(jnp.asarray(xi0), jnp.asarray(de), p.values)
    out = make_j2_history_drive(tp)(torch.tensor(xi0), torch.tensor(de),
                                    tp.values)
    assert out.shape == (8, n)
    assert_rows_close(out, ref)
    if t_steps == 0:
        np.testing.assert_array_equal(out.numpy(), xi0)


@pytest.mark.parametrize("kwargs", [
    {"layout": "wide", "record_alpha": True},
    {"layout": "wide", "fused": False},
    {"layout": "aos"},
])
def test_drive_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError):
        make_j2_history_drive(None, **kwargs)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Here there is no GPU: the script exits non-zero and prints no
    result, from the checkout and from a directory that holds nothing
    else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                assert not json.loads(line).get("ok")
