"""cmad_tpu_torch's parameter machinery against cmad_tpu's, and the
port's import hygiene.

The J2+Voce trees of ``tests/support/problems.py`` go to both packages
(to the port as numpy, ``jax.tree.map(np.asarray, ...)``); flat order,
canonical/physical maps, transforms and elastic-constant conversions
must agree to float64 roundoff.
"""
from __future__ import annotations

import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.io.params_builder import build_parameters as jax_build
from cmad_tpu.models.elastic_constants import ElasticConstants as JaxEC
from cmad_tpu.ops.j2_radial_return import j2_voce_scalars as jax_scalars
from cmad_tpu_torch import config
from cmad_tpu_torch.io.params_builder import build_parameters
from cmad_tpu_torch.models.elastic_constants import ElasticConstants
from cmad_tpu_torch.ops.j2_radial_return import j2_voce_scalars
from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

from tests.support.problems import params_J2_voce

torch.set_num_threads(1)

F64 = torch.float64
REPO = Path(__file__).resolve().parents[2]
FLAT = np.array([200e3, 0.3, 200.0, 200.0, 20.0])  # E, nu, Y, S, D


def _pair(scale_params):
    p = params_J2_voce(FLAT, scale_params)[0]
    tp = parameters_from_numpy(jax.tree.map(np.asarray, p.values),
                               p._active_flags, p._transforms,
                               dtype=F64, device="cpu")
    return p, tp


@pytest.mark.parametrize("scale_params", [True, False])
def test_flat_layout_and_values_match(scale_params):
    p, tp = _pair(scale_params)
    assert tp.num_params == p.num_params
    assert tp.num_active_params == p.num_active_params == 3
    np.testing.assert_array_equal(tp.active_idx, p.active_idx)
    assert tp._names == p._names
    assert tp.flat_param_sizes == p.flat_param_sizes
    # ravel_pytree order: sorted keys -> [D, S, Y]
    np.testing.assert_array_equal(tp.flat_active_values(), [20.0, 200.0,
                                                            200.0])
    np.testing.assert_allclose(tp.flat_active_values(True),
                               p.flat_active_values(True), rtol=1e-15,
                               atol=1e-15)
    np.testing.assert_array_equal(tp.opt_bounds, p.opt_bounds)


@pytest.mark.parametrize("scale_params", [True, False])
def test_canonical_maps_and_transforms_match(scale_params):
    p, tp = _pair(scale_params)
    rng = np.random.default_rng(0)
    a = rng.uniform(-0.9, 0.9, size=3)
    np.testing.assert_allclose(
        tp.physical_from_canonical_active(torch.tensor(a)).numpy(),
        np.asarray(p.physical_from_canonical_active(jnp.asarray(a))),
        rtol=1e-15)
    g = rng.normal(size=3)
    H = rng.normal(size=(3, 3))
    np.testing.assert_allclose(tp.transform_grad(g), p.transform_grad(g),
                               rtol=1e-15)
    np.testing.assert_allclose(tp.transform_hessian(H, g),
                               p.transform_hessian(H, g), rtol=1e-15)
    tp.set_active_values_from_flat(a)
    p.set_active_values_from_flat(a)
    np.testing.assert_allclose(tp.flat_active_values(),
                               p.flat_active_values(), rtol=1e-15)


@pytest.mark.parametrize("scale_params", [True, False])
def test_gradient_through_flat_canonical_vector_matches(scale_params):
    """``tree_with_flat_active`` is differentiable: the gradient of a
    function of the material scalars with respect to the canonical
    active vector agrees with jax.grad."""
    p, tp = _pair(scale_params)
    a = np.array([0.1, -0.2, 0.3])
    w = np.array([1e-5, 2e-5, 1.0, -0.5, 3.0])

    def jf(a_):
        tree = p.tree_with_flat_active(a_, canonical=True)
        return jnp.sum(jnp.asarray(w) * jax_scalars(tree, jnp.float64))

    at = torch.tensor(a, requires_grad=True)
    val = (torch.tensor(w) * j2_voce_scalars(
        tp.tree_with_flat_active(at, canonical=True), F64)).sum()
    (grad,) = torch.autograd.grad(val, at)
    np.testing.assert_allclose(float(val), float(jf(jnp.asarray(a))),
                               rtol=1e-14)
    np.testing.assert_allclose(grad.numpy(),
                               np.asarray(jax.grad(jf)(jnp.asarray(a))),
                               rtol=1e-13)


_ELASTIC = {"E": 200e3, "nu": 0.3}
_ELASTIC["mu"] = _ELASTIC["E"] / (2.0 * (1.0 + _ELASTIC["nu"]))
_ELASTIC["lambda"] = (200e3 * 0.3 / ((1.0 + 0.3) * (1.0 - 2.0 * 0.3)))
_ELASTIC["kappa"] = _ELASTIC["E"] / (3.0 * (1.0 - 2.0 * _ELASTIC["nu"]))
_PAIRS = [(a, b) for i, a in enumerate(_ELASTIC)
          for b in list(_ELASTIC)[i + 1:]]


@pytest.mark.parametrize("pair", _PAIRS, ids=["-".join(p) for p in _PAIRS])
def test_elastic_constants_from_every_pair(pair):
    given = {k: _ELASTIC[k] for k in pair}
    ref = JaxEC.from_params({k: jnp.float64(v) for k, v in given.items()})
    got = ElasticConstants.from_params(
        {k: torch.tensor(v, dtype=F64) for k, v in given.items()})
    for name in ("lmbda", "mu", "kappa", "E", "nu"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-13)
    np.testing.assert_allclose(float(got.mu), _ELASTIC["mu"], rtol=1e-12)


def test_elastic_constants_reject_one_constant():
    with pytest.raises(ValueError, match="need exactly two"):
        ElasticConstants.from_params({"E": 1.0})


def test_build_parameters_from_deck_matches():
    deck = {
        "rotation matrix": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                            [0.0, 0.0, 1.0]],
        "elastic": {"E": 200000, "nu": 0.3},
        "plastic": {
            "effective stress": {"J2": 0},
            "flow stress": {
                "initial yield": {"Y": {"value": 200.0, "active": True,
                                        "transform": {"log": 200.0}}},
                "hardening": {"voce": {
                    "S": {"value": 200.0, "active": True,
                          "transform": {"bounds": [100.0, 300.0]}},
                    "D": {"value": 20.0, "active": True}}}}}}
    p = jax_build(deck)
    tp = build_parameters(deck, device="cpu")
    assert tp.dtype == F64 and tp.device.type == "cpu"
    np.testing.assert_array_equal(tp.active_idx, p.active_idx)
    np.testing.assert_allclose(tp.flat_active_values(True),
                               p.flat_active_values(True), rtol=1e-15)
    np.testing.assert_allclose(tp._ravel(tp.values).numpy(),
                               np.asarray(p._flat_values), rtol=0)
    with pytest.raises(ValueError, match="unknown transform"):
        build_parameters({"Y": {"value": 1.0, "transform": {"exp": 1}}},
                         device="cpu")
    # the default is the card: without one, a call that does not ask
    # for the CPU raises instead of running there
    default = inspect.signature(build_parameters).parameters["device"]
    assert default.default == config.DEFAULT_DEVICE
    assert config.DEFAULT_DEVICE == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_parameters(deck)


def test_port_imports_neither_jax_nor_cmad_tpu():
    """Importing the port and every one of its modules, in a fresh
    interpreter, leaves jax and cmad_tpu out of sys.modules, and the deck
    parsers too (yaml, jsonschema, h5py: the GPU host has none of them,
    and the FE entry points and commands take the deck as a dict). The
    walk covers the ``cli``, ``io``, ``util``, ``qois`` and ``objectives``
    subpackages, the commands and ``python -m cmad_tpu_torch``'s
    ``__main__``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cmad_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "cmad_tpu_torch.__path__, 'cmad_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'cmad_tpu', 'yaml', 'jsonschema', 'h5py'))\n"
        "assert not bad, bad\n"
        "assert {'cmad_tpu_torch.cli.fe_common', "
        "'cmad_tpu_torch.global_residuals.small_disp_equilibrium', "
        "'cmad_tpu_torch.__main__', 'cmad_tpu_torch.cli.main', "
        "'cmad_tpu_torch.cli.fe_subcommands', "
        "'cmad_tpu_torch.cli.calibrate', "
        "'cmad_tpu_torch.cli.common', 'cmad_tpu_torch.io.schema', "
        "'cmad_tpu_torch.io.writers', 'cmad_tpu_torch.io.fe_writers', "
        "'cmad_tpu_torch.io.exodus', 'cmad_tpu_torch.io.results', "
        "'cmad_tpu_torch.io.restart', 'cmad_tpu_torch.fem.postprocess', "
        "'cmad_tpu_torch.util.profiling', "
        "'cmad_tpu_torch.cli.mp_subcommands', "
        "'cmad_tpu_torch.cli.sensitivity', "
        "'cmad_tpu_torch.objectives.mp_jvp_objective', "
        "'cmad_tpu_torch.qois.uniaxial_calibration', "
        "'cmad_tpu_torch.io.deformation'} <= set(names)\n"
        "print('imported', len([k for k in sys.modules "
        "if k.startswith('cmad_tpu_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 14
