"""cmad_tpu_torch's plain J2+Voce radial returns against cmad_tpu.

The same numpy inputs (``numpy.random.default_rng``) go through the JAX
package (its XLA step, and the Pallas kernel K1 in interpret mode, as the
JAX suite runs it on the CPU) and through the port's plain PyTorch
version, all in float64. Tolerance per state row:
``max|port - ref| <= 1e-12 * max(1, max|ref_row|)`` — both sides apply
the same f64 operations in the same order, so only reassociation and
libm ``exp`` differ.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.ops import j2_radial_return as jref
from cmad_tpu.ops.pallas_radial_return import (
    _to_wide as jax_to_wide,
    make_pallas_j2_radial_return_soa,
)
from cmad_tpu_torch.ops import cuda_radial_return as cuda_rr
from cmad_tpu_torch.ops import j2_radial_return as port
from cmad_tpu_torch.ops.return_map import make_soa_radial_return
from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

from tests.support.problems import J2AnalyticalProblem
from tests.support.torch_port import assert_rows_close

torch.set_num_threads(1)

F64 = torch.float64
N = 333  # not a multiple of the Pallas tile: the JAX side pads


@pytest.fixture(scope="module")
def params():
    """(JAX Parameters, the port's Parameters) for the J2+Voce problem."""
    p = J2AnalyticalProblem().J2_parameters
    tp = parameters_from_numpy(jax.tree.map(np.asarray, p.values),
                               dtype=F64, device="cpu")
    return p, tp


def _soa_inputs(n=N, seed=0):
    """Prior stresses inside the initial yield surface, a small prior
    alpha and a strain increment sized so that about half the points
    yield."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((8, n))
    xi[:6] = rng.normal(0.0, 30.0, size=(6, n))
    xi[6] = np.abs(rng.normal(0.0, 0.005, size=n))
    de = np.zeros((8, n))
    de[:6] = rng.normal(0.0, 0.4e-3, size=(6, n))
    return xi, de


def _grad_inputs(n=N, seed=1):
    rng = np.random.default_rng(seed)
    g = rng.normal(0.0, 1.2e-3, size=(n, 3, 3))
    g0 = 0.5 * g + rng.normal(0.0, 2e-4, size=(n, 3, 3))
    xi = np.zeros((n, 7))
    xi[:, :6] = rng.normal(0.0, 30.0, size=(n, 6))
    xi[:, 6] = np.abs(rng.normal(0.0, 0.005, size=n))
    return xi, g, g0


def _plastic_fraction(out, xi):
    return float(np.mean(np.asarray(out)[6] > np.asarray(xi)[6]))


def test_material_scalars_match(params):
    p, tp = params
    ref = np.asarray(jref.j2_voce_scalars(p.values, jnp.float64))
    got = port.j2_voce_scalars(tp.values, F64)
    assert got.dtype == F64 and got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15)


def test_plain_soa_step_matches_jax_step(params):
    p, tp = params
    xi, de = _soa_inputs()
    ref = jref.soa_step_scalars(jnp.asarray(xi), jnp.asarray(de),
                                jref.j2_voce_scalars(p.values, jnp.float64))
    out = port.soa_step_scalars(torch.tensor(xi), torch.tensor(de),
                                port.j2_voce_scalars(tp.values, F64))
    assert 0.2 <= _plastic_fraction(out, xi) <= 0.8
    assert_rows_close(out, ref)
    assert torch.all(out[7] == 0)


def test_plain_soa_step_matches_pallas_k1_interpret(params):
    """K1 ``_kernel_soa`` in interpret mode, N padded to its tile."""
    p, tp = params
    xi, de = _soa_inputs(seed=2)
    ref = make_pallas_j2_radial_return_soa(p, interpret=True)(
        jnp.asarray(xi), jnp.asarray(de), p.values)
    out = port.make_j2_radial_return_soa(tp)(
        torch.tensor(xi), torch.tensor(de), tp.values)
    assert 0.2 <= _plastic_fraction(out, xi) <= 0.8
    assert_rows_close(out, ref)


@pytest.mark.parametrize("builder", [port.make_j2_radial_return_soa,
                                     make_soa_radial_return])
def test_soa_builders_match_jax(params, builder):
    """The plain builder and the device-dispatching one agree with the
    JAX XLA form on CPU tensors, over two chained steps."""
    p, tp = params
    xi, de = _soa_inputs(seed=3)
    jstep = jref.make_j2_radial_return_soa(p)
    step = builder(tp)
    ref1 = jstep(jnp.asarray(xi), jnp.asarray(de), p.values)
    ref2 = jstep(ref1, 0.7 * jnp.asarray(de), p.values)
    out1 = step(torch.tensor(xi), torch.tensor(de), tp.values)
    out2 = step(out1, 0.7 * torch.tensor(de), tp.values)
    assert_rows_close(out1, ref1)
    assert_rows_close(out2, ref2)


def test_aos_form_matches_jax(params):
    """Plain version of K4: AoS state, displacement gradients in."""
    p, tp = params
    xi, g, g0 = _grad_inputs()
    xi_r, sig_r = jref.make_j2_radial_return(p)(
        jnp.asarray(xi), jnp.asarray(g), jnp.asarray(g0), p.values)
    xi_t, sig_t = port.make_j2_radial_return(tp)(
        torch.tensor(xi), torch.tensor(g), torch.tensor(g0), tp.values)
    assert 0.2 <= float(np.mean(np.asarray(xi_r)[:, 6] > xi[:, 6])) <= 0.8
    assert_rows_close(xi_t.T, np.asarray(xi_r).T)
    assert_rows_close(sig_t.reshape(-1, 9).T,
                      np.asarray(sig_r).reshape(-1, 9).T)


def test_total_form_matches_jax(params):
    """Plain version of K5: plastic-strain state, total strain in."""
    p, tp = params
    rng = np.random.default_rng(4)
    g = rng.normal(0.0, 0.5e-3, size=(N, 3, 3))
    xi = np.zeros((N, 7))
    xi[:, :6] = rng.normal(0.0, 3e-4, size=(N, 6))
    xi[:, 6] = np.abs(rng.normal(0.0, 0.005, size=N))
    xi_r, sig_r = jref.make_j2_radial_return_total(p)(
        jnp.asarray(xi), jnp.asarray(g), jnp.zeros((N, 3, 3)), p.values)
    xi_t, sig_t = port.make_j2_radial_return_total(tp)(
        torch.tensor(xi), torch.tensor(g), torch.zeros((N, 3, 3), dtype=F64),
        tp.values)
    assert 0.2 <= float(np.mean(np.asarray(xi_r)[:, 6] > xi[:, 6])) <= 0.8
    assert_rows_close(xi_t.T, np.asarray(xi_r).T)
    assert_rows_close(sig_t.reshape(-1, 9).T,
                      np.asarray(sig_r).reshape(-1, 9).T)


def test_soa_helpers_match_jax():
    rng = np.random.default_rng(5)
    xi = rng.normal(size=(37, 7))
    g, g0 = rng.normal(size=(2, 37, 3, 3))
    soa = port.pack_state_soa(torch.tensor(xi))
    np.testing.assert_array_equal(soa.numpy(),
                                  np.asarray(jref.pack_state_soa(xi)))
    np.testing.assert_array_equal(port.unpack_state_soa(soa).numpy(), xi)
    np.testing.assert_array_equal(
        port.stress_from_state_soa(soa).numpy(),
        np.asarray(jref.stress_from_state_soa(jref.pack_state_soa(xi))))
    np.testing.assert_array_equal(
        port.strain_increment_soa(torch.tensor(g), torch.tensor(g0)).numpy(),
        np.asarray(jref.strain_increment_soa(jnp.asarray(g),
                                             jnp.asarray(g0))))


def test_wide_view_is_the_same_bytes():
    """``_to_wide`` is a view (no copy), orders points exactly as the
    JAX package's ``_to_wide``, and a step on the round-tripped view is
    bit-identical to the soa8 step."""
    xi, de = _soa_inputs(n=400, seed=6)
    x = torch.tensor(xi)
    w = cuda_rr._to_wide(x)
    assert w.shape == (64, 50) and w.data_ptr() == x.data_ptr()
    np.testing.assert_array_equal(w.numpy(), np.asarray(jax_to_wide(xi)))
    assert cuda_rr._from_wide(w).data_ptr() == x.data_ptr()
    sc = torch.tensor([76923.1, 115384.6, 200.0, 200.0, 20.0], dtype=F64)
    narrow = port.soa_step_scalars(x, torch.tensor(de), sc)
    via_wide = port.soa_step_scalars(
        cuda_rr._from_wide(w), cuda_rr._from_wide(cuda_rr._to_wide(
            torch.tensor(de))), sc)
    assert torch.equal(narrow, via_wide)
    with pytest.raises(ValueError, match="divisible by 8"):
        cuda_rr._to_wide(torch.zeros((8, 12), dtype=F64))


@pytest.mark.parametrize("wrapper", ["step", "history"])
def test_cuda_wrappers_raise_on_cpu_tensors(wrapper):
    """The kernel wrappers take CUDA tensors only: a CPU tensor raises
    before anything is built, so no nvcc is needed."""
    xi = torch.zeros((8, 16), dtype=F64)
    sc = torch.ones(5, dtype=F64)
    before = cuda_rr.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        if wrapper == "step":
            cuda_rr.soa_step_scalars_cuda(xi, xi, sc)
        else:
            cuda_rr.soa_history_cuda(xi, xi[None], sc)
    assert cuda_rr.launch_counts() == before


def test_dispatch_rejects_other_devices(params):
    _p, tp = params
    step = make_soa_radial_return(tp)
    xi = torch.zeros((8, 4), dtype=F64, device="meta")
    with pytest.raises(ValueError, match="no J2 return map"):
        step(xi, xi, tp.values)


def test_kernel_build_module_imports_without_nvcc():
    from cmad_tpu_torch.ops import _build

    assert _build.sources() and all(p.exists() for p in _build.sources())
    assert _build.library_path().name.startswith("libj2_radial_return_")
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def _load_build_copy(tmp_path):
    """``ops/_build.py`` of a copy of the package under ``tmp_path``,
    loaded from the copy (so its ``csrc/`` is the copy's)."""
    import importlib.util
    import shutil

    from cmad_tpu_torch.ops import _build

    pkg = tmp_path / "cmad_tpu_torch"
    shutil.copytree(_build.CSRC, pkg / "csrc")
    (pkg / "ops").mkdir()
    shutil.copy(_build.__file__, pkg / "ops" / "_build.py")
    spec = importlib.util.spec_from_file_location(
        "_build_copy", pkg / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, pkg / "csrc"


def test_library_path_keys_every_csrc_file(tmp_path):
    """A change to any file under ``csrc/`` (a header included) gives a
    new library path, so a stale library is never loaded; every ``.cu``
    is a translation unit. No nvcc needed."""
    mod, csrc = _load_build_copy(tmp_path)
    first = mod.library_path()
    assert first.parent == tmp_path / "build" / "cmad_tpu_torch"
    assert mod.library_path() == first
    header = csrc / "extra.cuh"
    header.write_text("// a header\n")
    with_header = mod.library_path()
    assert with_header != first
    header.write_text("// a changed header\n")
    assert mod.library_path() not in (first, with_header)
    header.unlink()
    assert mod.library_path() == first
    units = sorted(p.name for p in csrc.glob("*.cu"))
    assert [p.name for p in mod.sources()] == units
    cu = sorted(csrc.glob("*.cu"))[0]
    cu.write_text(cu.read_text() + "\n")
    assert mod.library_path() != first
    (csrc / "second.cu").write_text("// another unit\n")
    assert [p.name for p in mod.sources()] == sorted(units + ["second.cu"])


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_118j2_soa_step_kernelIdEEvPKT_S3_S3_PS1_l
        /*0000*/                   LDG.E.64 R4, desc[UR4][R2.64] ;
        /*0010*/                   DFMA R4, R2, R4, R6 ;
        /*0020*/                   DADD R4, R2, R4 ;
        /*0030*/                   MUFU.RSQ64H R5, R3 ;
        /*0040*/              @!P1 BRA `(.L_x_1) ;
        /*0050*/                   MUFU.RCP64H R5, R3 ;
        /*0060*/                   DFMA R4, R2, R4, R6 ;
        /*0070*/                   DMUL R4, R2, R4 ;
        /*0080*/               @P0 CALL.REL.NOINC `(.L_x_2) ;
.L_x_1:
        /*0090*/                   BSYNC B0 ;
        /*00a0*/                   STG.E.64 desc[UR4][R2.64], R4 ;
        /*00b0*/                   EXIT ;
.L_x_2:
        /*00c0*/                   DFMA R4, R2, R4, R6 ;
        /*00d0*/                   RET.REL.NODEC R2 0x0 ;
"""


def test_sass_counts_split_every_update_from_plastic():
    """The bound's operation counts: a fused multiply-add counts 2, an
    add or multiply 1; what a predicated forward branch skips over a
    divide is the plastic update's extra; called slow paths are left
    out."""
    from cmad_tpu_torch.ops import _sass

    funcs = _sass.parse(_SASS)
    assert list(funcs) == ["j2_soa_step<double>"]
    c = _sass.kernel_counts(funcs["j2_soa_step<double>"])
    assert c["elastic"] == {"fp64": 3, "fp32": 0}
    assert c["plastic"] == {"fp64": 3, "fp32": 0}
    assert c["updates"] == 1
    assert c["mnemonics"] == {"DADD": 1, "DFMA": 2, "DMUL": 1,
                              "MUFU.RCP64H": 1, "MUFU.RSQ64H": 1}
