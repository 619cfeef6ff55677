"""The roofline experiment's kernel R in cmad_tpu_torch (``ops/roofline.py``)
against the JAX package's, on the CPU.

R is the f32 SoA history with the Newton's iteration count and the steps
per launch as parameters (``benchmarks/local_kernels/roofline_experiment.py``
``_make_hist_call``). Its plain version (``plain_drive``: the plain step
with ``newton_iters=n`` over the history) is held, for every row of both
sweeps, to the JAX package's ``_radial_rows(newton_iters=n)`` (the Pallas
kernel's body) chained over the same chunks in JAX on the CPU. Both run
in float32 with their own order of operations, which differ by rounding
(2.8e-7 of a state row's scale at most over these 16 steps); the bound is
the f32 step bound of ``chip_smoke.py``, 1e-5 of each row's scale.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.ops.pallas_radial_return import _radial_rows
from cmad_tpu_torch.ops import cuda_radial_return as cuda_rr
from cmad_tpu_torch.ops import roofline as rl

torch.set_num_threads(1)

N, T = 256, 16
ROWS = [(it, 8) for it in rl.ITERS] + [(8, ts) for ts in rl.T_STEPS]
F32_BOUND = 1e-5


@pytest.fixture(scope="module")
def data():
    return rl.roofline_data(n=N, t_hist=T, device="cpu")


def _jax_drive(xi0, de, sc, t_steps, iters):
    """R's body in JAX: ``_radial_rows`` over each chunk of ``t_steps``
    steps, row 7 zero after each chunk."""
    mu, lam, Y, S, D = (jnp.float32(v) for v in sc.tolist())
    xi = jnp.asarray(xi0.numpy())
    for c in range(0, T, t_steps):
        rows = tuple(xi[r:r + 1] for r in range(7))
        for t in range(c, c + t_steps):
            rows = _radial_rows(rows, tuple(jnp.asarray(de[t, r:r + 1].numpy())
                                            for r in range(6)),
                                mu, lam, Y, S, D, newton_iters=iters)
        xi = jnp.concatenate([*rows, jnp.zeros_like(rows[6])])
    return np.asarray(xi)


@pytest.mark.parametrize("iters,t_steps", ROWS)
def test_plain_r_matches_jax(data, iters, t_steps):
    xi0, de, sc = data
    out = rl.plain_drive(xi0, de, sc, iters)
    ref = torch.as_tensor(_jax_drive(xi0, de, sc, t_steps, iters))
    assert out.dtype == torch.float32 and ref.dtype == torch.float32
    abs_err, rel_err = rl.row_scaled_error(out, ref)
    assert rel_err <= F32_BOUND, (abs_err, rel_err)
    assert bool((out[6] > xi0[6]).any())      # some points yield
    assert torch.equal(out[7], torch.zeros_like(out[7]))


def test_data_follow_the_experiment_recipe(data):
    xi0, de, sc = data
    rng = np.random.default_rng(0)
    x = rng.normal(0, 50.0, (8, N)).astype(np.float32)
    x[6] = np.abs(x[6]) * 1e-3
    x[7] = 0.0
    d = rng.normal(0, 2e-3, (T, 8, N)).astype(np.float32)
    d[:, 6:] = 0.0
    assert np.array_equal(xi0.numpy(), x) and np.array_equal(de.numpy(), d)
    assert sc.tolist() == pytest.approx(
        [76923.1, 115384.6, 250.0, 200.0, 20.0])


def test_bytes_per_update_follow_the_port_layout():
    assert [rl.bytes_per_update(t) for t in rl.T_STEPS] == [
        84.0, 54.0, 39.0, 31.5, 27.75]      # 24 + 60 / t_steps, f32
    assert rl.bytes_per_update(8, itemsize=8) == 63.0


def test_chunks_and_kernel_wrapper_checks(data):
    xi0, de, sc = data
    chunks = rl.chunks_of(de, 4)
    assert len(chunks) == 4 and all(c.shape == (4, 8, N) for c in chunks)
    assert all(c.is_contiguous() for c in chunks)
    with pytest.raises(ValueError, match="multiple"):
        rl.chunks_of(de, 3)
    with pytest.raises(ValueError, match="newton_iters"):
        cuda_rr.soa_history_iters_cuda(xi0, de, sc, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rr.soa_history_iters_cuda(xi0, de, sc, 8)
    assert cuda_rr.launch_counts()["j2_soa_history_iters"] == 0


def test_sass_keys_carry_template_arguments():
    from cmad_tpu_torch.ops._sass import kernel_key

    ns = "_ZN47_GLOBAL__N__c4100_19_j2_radial_return_cu_ed0d09e7"
    assert kernel_key(ns + "21j2_soa_history_kernelIfLi12EEEvPKT_") == \
        "j2_soa_history<float, 12>"
    assert kernel_key(ns + "18j2_aos_step_kernelIdEEvPKT_") == \
        "j2_aos_step<double>"
    assert kernel_key("_ZN47_GLOBAL__N__fa68b9e6_14_segment_sum_cu_c650e772"
                      "18segment_sum_kernelIdLb1ELb0EEEvPKT_") == \
        "segment_sum<double, 1, 0>"
