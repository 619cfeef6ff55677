"""cmad_tpu_torch's elastic model and its stress forms against cmad_tpu's.

The same numpy deformation gradients and states
(``numpy.random.default_rng``) go through both packages in float64:

- the elastic stress forms, ``compute_invariants`` and
  ``compute_cauchy_from_psi_b``: 1e-13 relative per row
  (``max|port - ref| <= rtol * max(1, max|ref_row|)``); the neo-Hookean
  forms to 1e-12, because the port's ``J^(-2/3)`` is ``J.pow(-2/3)``
  where cmad_tpu takes ``cbrt(J) ** -2`` and its determinant is the
  closed-form 3x3 one where cmad_tpu runs an LU: each rounds J apart by
  an ulp or two, which ``kappa (J^2 - 1)`` carries into stresses of
  ``kappa |J - 1|`` (measured below 1e-13 at these strains);
- ``Elastic``'s residual and Cauchy stress for all four def types, its
  closed form for FULL_3D and PLANE_STRAIN (the others have none), and
  the deviatoric and hydrostatic parts, the scale factors, at 1e-13;
- the interpolation of the element coefficients to a point, bit for bit
  in the fields' layout and at 1e-14;
- ``parameters_from_numpy`` on the elastic tree: the JAX package's flat
  order and values.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.fem.elements import ShapeFunctionsAtIP as JaxShapes
from cmad_tpu.global_residuals.interpolation import (
    interpolate_global_fields_at_ip as jax_interp,
)
from cmad_tpu.models import elastic_potential as jax_pot
from cmad_tpu.models import elastic_stress as jax_es
from cmad_tpu.models import kinematics as jax_kin
from cmad_tpu.models.deformation_types import DefType as JaxDefType
from cmad_tpu.models.elastic import Elastic as JaxElastic
from cmad_tpu.models.global_fields import GlobalFieldsAtPoint as JaxU
from cmad_tpu.parameters.parameters import Parameters as JaxParameters
from cmad_tpu_torch.fem.elements import ShapeFunctionsAtIP
from cmad_tpu_torch.global_residuals.interpolation import (
    interpolate_global_fields_at_ip,
)
from cmad_tpu_torch.io.registry import resolve_model
from cmad_tpu_torch.models import elastic_potential, elastic_stress
from cmad_tpu_torch.models.deformation_types import DefType, def_type_ndims
from cmad_tpu_torch.models.elastic import Elastic
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.models.kinematics import compute_invariants
from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

from tests.support.torch_port import assert_rows_close

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-13
NEO_RTOL = 1e-12
K = 8                                   # points per case
ELASTIC = {"elastic": {"E": 1000.0, "nu": 0.25}}
FORMS = ["isotropic_linear", "neohookean"]
DEF_TYPES = [DefType.FULL_3D, DefType.PLANE_STRAIN, DefType.PLANE_STRESS,
             DefType.UNIAXIAL_STRESS]


@pytest.fixture(scope="module")
def params():
    jp = JaxParameters(ELASTIC)
    tp = parameters_from_numpy(jax.tree.map(np.asarray, jp.values),
                               dtype=F64, device="cpu")
    return jp, tp


def _grads(seed, nd=3, scale=0.05):
    return np.random.default_rng(seed).normal(0.0, scale, size=(K, nd, nd))


def test_parameters_from_numpy_takes_the_elastic_tree(params):
    """The elastic tree (E and nu only) carries across in the JAX
    package's flat order."""
    from jax.flatten_util import ravel_pytree

    jp, tp = params
    np.testing.assert_array_equal(Elastic(tp).flat_params().numpy(),
                                  np.asarray(ravel_pytree(jp.values)[0]))
    assert tp.num_params == 2
    assert float(tp.values["elastic"]["nu"]) == 0.25
    assert tp.values["elastic"]["E"].dtype == F64


@pytest.mark.parametrize("form", FORMS)
def test_stress_forms_match_cmad_tpu(params, form):
    jp, tp = params
    F = np.eye(3) + _grads(FORMS.index(form))
    got = elastic_stress.conventional_elastic_stress_fun(form)(
        torch.tensor(F), tp.values)
    ref = jax_es.conventional_elastic_stress_fun(form)(jnp.asarray(F),
                                                       jp.values)
    assert_rows_close(got, ref, rtol=NEO_RTOL if form == "neohookean"
                      else RTOL)
    with pytest.raises(NotImplementedError, match="unknown"):
        elastic_stress.conventional_elastic_stress_fun("hooke")


def test_invariants_and_stress_from_potential_match_cmad_tpu():
    F = np.eye(3) + _grads(3)[0]
    b = F @ F.T
    got = compute_invariants(torch.tensor(b))
    ref = jax_kin.compute_invariants(jnp.asarray(b))
    for g, r in zip(got, ref, strict=True):
        assert abs(float(g) - float(r)) <= RTOL * max(1.0, abs(float(r)))
    p = {"elastic": {"kappa": 2000.0 / 3.0, "mu": 400.0}}
    sigma = elastic_potential.compute_cauchy_from_psi_b(
        torch.tensor(F), {"elastic": {k: torch.tensor(v, dtype=F64)
                                      for k, v in p["elastic"].items()}},
        elastic_potential.compressible_neohookean_potential)
    ref = jax_pot.compute_cauchy_from_psi_b(
        jnp.asarray(F), p, jax_pot.compressible_neohookean_potential)
    assert_rows_close(sigma, ref, rtol=NEO_RTOL)
    # the potential's stress is the closed form's
    closed = elastic_stress.compressible_neohookean_cauchy_stress(
        torch.tensor(F), {"elastic": {"E": torch.tensor(1000.0, dtype=F64),
                                      "nu": torch.tensor(0.25, dtype=F64)}})
    assert_rows_close(sigma, closed, rtol=NEO_RTOL)


def _fields(g, make, array):
    nd = g.shape[-1]
    return make({"u": array(np.zeros(nd))}, {"u": array(g)})


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("def_type", DEF_TYPES, ids=lambda d: d.name)
def test_elastic_model_matches_cmad_tpu(params, def_type, form):
    jp, tp = params
    jm = JaxElastic(jp, jax_es.conventional_elastic_stress_fun(form),
                    JaxDefType(int(def_type)))
    tm = Elastic(tp, elastic_stress.conventional_elastic_stress_fun(form),
                 def_type)
    assert tm.num_dofs == jm.num_dofs and tm.var_names == jm.var_names
    rng = np.random.default_rng(40 + int(def_type))
    nd = def_type_ndims(def_type)
    g = rng.normal(0.0, 0.02, size=(K, nd, nd))
    xi = rng.normal(0.0, 10.0, size=(K, tm.num_dofs))
    xi[:, 6:] = 1.0 + rng.normal(0.0, 0.01, size=(K, tm.num_dofs - 6))
    rtol = NEO_RTOL if form == "neohookean" else RTOL

    def jax_out(x, gg):
        U = _fields(gg, JaxU, jnp.asarray)
        out = [jm.residual_fun(x, x, jp.values, U, U),
               jm.cauchy_fun(x, x, jp.values, U, U)]
        if jm.cauchy_closed_form_fun is not None:
            out.append(jm.cauchy_closed_form_fun(jp.values, U, U))
        return out

    ref = jax.vmap(jax_out)(jnp.asarray(xi), jnp.asarray(g))
    for k in range(K):
        U = _fields(g[k], GlobalFieldsAtPoint, torch.tensor)
        x = torch.tensor(xi[k])
        got = [tm.residual_fun(x, x, tp.values, U, U),
               tm.cauchy_fun(x, x, tp.values, U, U)]
        if def_type in (DefType.FULL_3D, DefType.PLANE_STRAIN):
            got.append(tm.cauchy_closed_form_fun(tp.values, U, U))
        else:
            assert tm.cauchy_closed_form_fun is None
        assert len(got) == len(ref)
        for a, b in zip(got, ref, strict=True):
            assert_rows_close(a[None], np.asarray(b)[k][None], rtol=rtol)


def test_elastic_split_and_scales_match_cmad_tpu(params):
    """The deviatoric and hydrostatic closed forms (the mixed u-p form's
    pieces; 3D displacement gradients) and the two scale factors."""
    jp, tp = params
    g = _grads(50, scale=0.01)
    for k in range(K):
        U = _fields(g[k], GlobalFieldsAtPoint, torch.tensor)
        JU = _fields(g[k], JaxU, jnp.asarray)
        assert_rows_close(Elastic.dev_cauchy_closed_form(tp.values, U, U),
                          JaxElastic.dev_cauchy_closed_form(jp.values, JU,
                                                            JU), rtol=RTOL)
        h = float(Elastic.hydro_cauchy_closed_form(tp.values, U, U))
        hr = float(JaxElastic.hydro_cauchy_closed_form(jp.values, JU, JU))
        assert abs(h - hr) <= RTOL * max(1.0, abs(hr))
    for name in ("pressure_scale_factor", "shear_scale_factor"):
        assert abs(float(getattr(Elastic, name)(tp.values))
                   - float(getattr(JaxElastic, name)(jp.values))) <= 1e-12
    assert Elastic.supports_closed_form_cauchy and Elastic.supports_mixed
    assert resolve_model("elastic") is Elastic
    assert Elastic(tp).derived_output_field_names() == ["cauchy"]
    neo = Elastic.from_deck({"elastic_stress": "neohookean"}, tp,
                            DefType.FULL_3D)
    assert neo.cauchy_closed_form_fun.keywords["elastic_stress"] \
        is elastic_stress.compressible_neohookean_cauchy_stress


def test_interpolation_matches_cmad_tpu():
    rng = np.random.default_rng(60)
    U = rng.normal(size=(8, 3))
    N, grad_N = rng.random(8), rng.normal(size=(8, 3))
    got = interpolate_global_fields_at_ip(
        [torch.tensor(U)], [ShapeFunctionsAtIP(torch.tensor(N),
                                               torch.tensor(grad_N))], ["u"])
    ref = jax_interp([jnp.asarray(U)], [JaxShapes(jnp.asarray(N),
                                                  jnp.asarray(grad_N))],
                     ["u"])
    for a, b in ((got.fields["u"], ref.fields["u"]),
                 (got.grad_fields["u"], ref.grad_fields["u"])):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-15)
    with pytest.raises(ValueError, match="var_names"):
        interpolate_global_fields_at_ip([torch.tensor(U)], [None], [None])
