"""cmad_tpu_torch's ``make_batched_return_map`` and its J2+Voce
specialisation against cmad_tpu's, and the dispatch rules of the AoS
return maps.

The same numpy inputs go through both packages in float64: the generic
implicit-function Newton and the analytic radial return (rate and total
form) over two chained steps, at the bound of
``tests/ops/test_j2_radial_return.py`` (1e-9 absolute: the Newton stops
at its 1e-14 relative tolerance, the radial return after 8 fixed scalar
iterations); and the plain AoS and total forms, the CPU versions of the
CUDA kernels ``j2_aos_step`` and ``j2_total_step``, against the TPU
kernels K4 and K5 run in interpret mode, as
``tests/ops/test_pallas_radial_return.py`` runs them (1e-12 of each
row's scale: the same f64 operations up to reassociation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.models.deformation_types import DefType as JaxDefType
from cmad_tpu.models.small_elastic_plastic import (
    SmallElasticPlastic as JaxTotal,
)
from cmad_tpu.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic as JaxRate,
)
from cmad_tpu.ops.pallas_radial_return import (
    make_pallas_j2_radial_return,
    make_pallas_j2_radial_return_total,
)
from cmad_tpu.ops.return_map import (
    j2_voce_kind as jax_kind,
    make_batched_return_map as jax_batched_return_map,
)
from cmad_tpu.parameters.parameters import Parameters as JaxParameters
from cmad_tpu_torch.models.deformation_types import DefType
from cmad_tpu_torch.models.hardening import get_hardening_funs
from cmad_tpu_torch.models.small_elastic_plastic import SmallElasticPlastic
from cmad_tpu_torch.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic,
)
from cmad_tpu_torch.ops import cuda_radial_return as cuda_rr
from cmad_tpu_torch.ops import j2_radial_return as port
from cmad_tpu_torch.ops.return_map import (
    j2_voce_kind,
    make_batched_return_map,
    make_j2_radial_return_for,
)
from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

from tests.support.problems import J2AnalyticalProblem
from tests.support.torch_port import assert_rows_close

torch.set_num_threads(1)

F64 = torch.float64
B = 256
MODELS = {"rate": (JaxRate, SmallRateElasticPlastic),
          "total": (JaxTotal, SmallElasticPlastic)}


@pytest.fixture(scope="module")
def params():
    p = J2AnalyticalProblem().J2_parameters
    tp = parameters_from_numpy(jax.tree.map(np.asarray, p.values),
                               dtype=F64, device="cpu")
    return p, tp


def _increments(n, seed):
    """The inputs of ``tests/ops/test_j2_radial_return.py``: symmetric
    N(0, 1.5e-3) displacement gradients from rest."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(0.0, 1.5e-3, size=(n, 3, 3))
    return 0.5 * (eps + np.transpose(eps, (0, 2, 1)))


def _chain(step, xi0, g, params, to):
    """Two chained steps: g from rest, then 1.7 g from g."""
    z = np.zeros_like(g)
    xi1, s1 = step(to(xi0), to(g), to(z), params)
    xi2, s2 = step(xi1, to(1.7 * g), to(g), params)
    return [np.asarray(v) for v in (xi1, s1, xi2, s2)]


@pytest.fixture(scope="module")
def generic_jax(params):
    """The JAX package's generic Newton over the two chained steps, per
    form (computed once: its compile dominates this module's time)."""
    p, _tp = params
    g = _increments(B, seed=0)
    return {form: _chain(jax_batched_return_map(MODELS[form][0](p)),
                         np.zeros((B, 7)), g, p.values, jnp.asarray)
            for form in MODELS}


@pytest.mark.parametrize("specialize", [False, True])
@pytest.mark.parametrize("form", ["rate", "total"])
def test_batched_return_map_matches_jax(params, generic_jax, form,
                                        specialize):
    _p, tp = params
    g = _increments(B, seed=0)
    step = make_batched_return_map(MODELS[form][1](tp),
                                   specialize=specialize)
    got = _chain(step, np.zeros((B, 7)), g, tp.values, torch.tensor)
    ref = generic_jax[form]
    assert 0.3 < float(np.mean(ref[0][:, 6] > 0)) < 1.0
    for a, b in zip(got, ref, strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_j2_voce_kind_matches_jax(params):
    """Rate, total, plane-stress, rotated and custom-hardening models
    are classified alike by both packages."""
    p, tp = params
    angle = 0.3
    rot = np.array([[np.cos(angle), -np.sin(angle), 0.0],
                    [np.sin(angle), np.cos(angle), 0.0], [0.0, 0.0, 1.0]])
    values = jax.tree.map(np.asarray, p.values)
    rotated = {**values, "rotation matrix": rot}
    jp_rot = JaxParameters(rotated)
    tp_rot = parameters_from_numpy(rotated, dtype=F64, device="cpu")
    cases = [
        (JaxRate(p), SmallRateElasticPlastic(tp), "rate"),
        (JaxTotal(p), SmallElasticPlastic(tp), "total"),
        (JaxRate(p, def_type=JaxDefType.PLANE_STRESS),
         SmallRateElasticPlastic(tp, def_type=DefType.PLANE_STRESS), None),
        (JaxTotal(p, def_type=JaxDefType.UNIAXIAL_STRESS),
         SmallElasticPlastic(tp, def_type=DefType.UNIAXIAL_STRESS), None),
        (JaxRate(jp_rot), SmallRateElasticPlastic(tp_rot), None),
        (JaxTotal(jp_rot), SmallElasticPlastic(tp_rot), None),
    ]
    for jm, tm, expected in cases:
        assert jax_kind(jm) == expected
        assert j2_voce_kind(tm) == expected
    custom = SmallRateElasticPlastic(tp, hardening_funs=get_hardening_funs())
    assert j2_voce_kind(custom) is None
    with pytest.raises(ValueError, match="not radial-return"):
        make_j2_radial_return_for(cases[2][1])


@pytest.mark.parametrize("form", ["rate", "total"])
def test_plain_aos_forms_match_pallas_interpret(params, form):
    """The CPU versions of ``j2_aos_step`` and ``j2_total_step`` against
    K4 ``_kernel`` and K5 ``_kernel_total`` in interpret mode (B not a
    multiple of their 2048-lane tile: the JAX side pads)."""
    p, tp = params
    n = 333 if form == "rate" else 300
    g = _increments(n, seed=2 if form == "rate" else 3)
    if form == "rate":
        ref_step = make_pallas_j2_radial_return(p, interpret=True)
        step = port.make_j2_radial_return(tp)
    else:
        ref_step = make_pallas_j2_radial_return_total(p, interpret=True)
        step = port.make_j2_radial_return_total(tp)
    ref = _chain(ref_step, np.zeros((n, 7)), g, p.values, jnp.asarray)
    got = _chain(step, np.zeros((n, 7)), g, tp.values, torch.tensor)
    assert 0.3 < float(np.mean(ref[0][:, 6] > 0)) < 1.0
    for a, b in zip(got, ref, strict=True):
        a2, b2 = a.reshape(n, -1), b.reshape(n, -1)
        assert_rows_close(a2.T, b2.T, rtol=1e-12)


@pytest.mark.parametrize("form", ["rate", "total"])
def test_cpu_dispatch_takes_the_plain_form(params, form):
    """On CPU tensors the specialised map is the plain form, bit for bit,
    and launches nothing; ``prefer_pallas=False`` returns the plain form
    itself; any device but the card and the CPU raises."""
    _p, tp = params
    model = MODELS[form][1](tp)
    plain = (port.make_j2_radial_return if form == "rate"
             else port.make_j2_radial_return_total)(tp)
    g = torch.tensor(_increments(16, seed=4))
    xi0 = torch.zeros((16, 7), dtype=F64)
    before = cuda_rr.launch_counts()
    for step in (make_batched_return_map(model, specialize=True),
                 make_j2_radial_return_for(model, prefer_pallas=False)):
        xi, sigma = step(xi0, g, torch.zeros_like(g), tp.values)
        xi_p, sigma_p = plain(xi0, g, torch.zeros_like(g), tp.values)
        assert torch.equal(xi, xi_p) and torch.equal(sigma, sigma_p)
    assert cuda_rr.launch_counts() == before
    meta = torch.zeros((4, 7), dtype=F64, device="meta")
    gm = torch.zeros((4, 3, 3), dtype=F64, device="meta")
    for spec in (True, False):
        with pytest.raises(ValueError, match="no J2 return map"):
            make_batched_return_map(model, specialize=spec)(
                meta, gm, gm, tp.values)


@pytest.mark.parametrize("kernel", ["aos", "total"])
def test_cuda_wrappers_raise_off_the_card_and_on_grad(params, kernel):
    """The CUDA wrappers take CUDA tensors only, and are forward-only: an
    input that requires grad raises, before anything is built."""
    _p, tp = params
    xi = torch.zeros((8, 7), dtype=F64)
    g = torch.zeros((8, 3, 3), dtype=F64)
    build = (cuda_rr.make_cuda_j2_radial_return if kernel == "aos"
             else cuda_rr.make_cuda_j2_radial_return_total)
    step = build(tp)
    before = cuda_rr.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        step(xi, g, g, tp.values)
    with pytest.raises(RuntimeError, match="forward-only"):
        step(xi, g.clone().requires_grad_(True), g, tp.values)
    Y = tp.values["plastic"]["flow stress"]["initial yield"]["Y"]
    graded = {**tp.values, "plastic": {
        **tp.values["plastic"], "flow stress": {
            **tp.values["plastic"]["flow stress"],
            "initial yield": {"Y": Y.clone().requires_grad_(True)}}}}
    with pytest.raises(RuntimeError, match="scalars requires grad"):
        step(xi, g, g, graded)
    assert cuda_rr.launch_counts() == before
