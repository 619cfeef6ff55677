"""FEProblem (immutable, fully-precomputed) + FEState (trajectory).

Port of ``cmad_tpu/fem/fe_problem.py`` (parity: reference
``cmad/fem/fe_problem.py``). Everything is resolved once at
construction: per-block evaluator dicts from ``gr.for_model``, the
geometry cache, the embedded-BC sparsity, the near-null space and the
kernel arrays, as tensors on the problem's ``device``. The FE entry
points run on ``config.DEFAULT_DEVICE`` (the card) unless the caller
passes ``device="cpu"``; without a card the default raises.

Neumann BCs and body forces are not on the ported path yet: the builder
accepts none and raises otherwise (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from cmad_tpu_torch.config import (
    DEFAULT_DEVICE,
    DEFAULT_DTYPE,
    checked_device,
)
from cmad_tpu_torch.fem.bcs import NeumannBC
from cmad_tpu_torch.fem.dof import GlobalDofMap, GlobalFieldLayout
from cmad_tpu_torch.fem.mesh import Mesh
from cmad_tpu_torch.fem.precompute import precompute_block_geometry
from cmad_tpu_torch.fem.quadrature import (
    QuadratureRule,
    default_assembly_quadrature,
)
from cmad_tpu_torch.fem.topology import ElementFamily
from cmad_tpu_torch.global_residuals.global_residual import GlobalResidual
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.models.model import Model

if TYPE_CHECKING:
    from cmad_tpu_torch.fem.kernel_arrays import FEKernelArrays
    from cmad_tpu_torch.fem.sparse_solve import EmbeddedSparsity

_NOT_PORTED_LOADS = ("Neumann BCs and body forces are not ported yet: "
                     "ROADMAP queue 1, item 8")


@dataclass(frozen=True)
class FEProblem:
    mesh: Mesh
    dof_map: GlobalDofMap
    gr: GlobalResidual
    models_by_block: dict[str, Model]
    modes_by_block: dict[str, GlobalResidualMode]
    evaluators_by_block: dict[str, dict]
    assembly_quadrature: dict[ElementFamily, QuadratureRule]
    device: torch.device
    dtype: torch.dtype

    field_layouts_per_block: list[GlobalFieldLayout] = field(
        init=False, default_factory=list)
    field_idx_per_block: list[int] = field(init=False, default_factory=list)
    geometry_cache: dict[str, dict] = field(init=False,
                                            default_factory=dict)
    kernel_arrays: "FEKernelArrays" = field(init=False, default=None)
    near_null_space: np.ndarray | None = field(init=False, default=None)
    # the two-level prolongator, built on first use
    # (nonlinear_solver.get_two_level_pattern)
    two_level_patterns: dict = field(init=False, default_factory=dict)

    def __post_init__(self):
        name_to_idx = {fl.name: i
                       for i, fl in enumerate(self.dof_map.field_layouts)}
        layouts, idxs = [], []
        for r in range(self.gr.num_residuals):
            var = self.gr.var_names[r]
            if var is None or var not in name_to_idx:
                raise ValueError(
                    f"GR var_names[{r}]={var!r} has no matching field "
                    f"layout (known: {sorted(name_to_idx)})")
            idx = name_to_idx[var]
            if int(self.gr._num_eqs[r]) != int(
                    self.dof_map.num_dofs_per_basis_fn[idx]):
                raise ValueError(
                    f"GR _num_eqs[{r}] disagrees with the dof map's "
                    f"component count for field {var!r}")
            idxs.append(idx)
            layouts.append(self.dof_map.field_layouts[idx])
        object.__setattr__(self, "field_layouts_per_block", layouts)
        object.__setattr__(self, "field_idx_per_block", idxs)
        object.__setattr__(self, "geometry_cache", precompute_block_geometry(
            self.mesh, self.assembly_quadrature, layouts, self.dtype,
            self.device))

        from cmad_tpu_torch.fem.kernel_arrays import build_fe_kernel_arrays
        object.__setattr__(self, "near_null_space",
                           self.gr.near_null_space(self.mesh))
        object.__setattr__(self, "kernel_arrays",
                           build_fe_kernel_arrays(self))

    @property
    def embedded_sparsity(self) -> "EmbeddedSparsity":
        return self.kernel_arrays.embedded_sparsity

    @property
    def ndims(self) -> int:
        return int(self.mesh.nodes.shape[1])

    def state_blocks(self) -> list[str]:
        """The blocks whose state evolves (COUPLED), in block order; a
        CLOSED_FORM block has none, and the drivers echo its initial
        state forward."""
        return [b for b in self.evaluators_by_block
                if self.modes_by_block[b] == GlobalResidualMode.COUPLED]

    def num_ips(self) -> int:
        return self.assembly_quadrature[
            self.mesh.element_family].num_points


@dataclass
class FEState:
    """Mutable trajectory on the host: full nodal U, AoS per-IP xi per
    block, t (numpy float64)."""

    U_history: list[np.ndarray]
    xi_history_by_block: dict[str, list[np.ndarray]]
    t_history: list[float]

    @classmethod
    def from_problem(cls, fe_problem: FEProblem, t_init: float = 0.0,
                     U_init: np.ndarray | None = None,
                     xi_init_by_block: dict[str, np.ndarray] | None = None
                     ) -> "FEState":
        n_dofs = fe_problem.dof_map.num_total_dofs
        U0 = (np.zeros(n_dofs) if U_init is None else U_init.copy())
        n_ips = fe_problem.num_ips()
        xi0: dict[str, list[np.ndarray]] = {}
        for block, model in fe_problem.models_by_block.items():
            if xi_init_by_block is not None and block in xi_init_by_block:
                xi0[block] = [np.asarray(xi_init_by_block[block]).copy()]
                continue
            n_elems = len(fe_problem.mesh.element_blocks[block])
            init = model.init_xi(dtype=torch.float64, device="cpu").numpy()
            xi0[block] = [np.tile(init, (n_elems, n_ips, 1))]
        return cls(U_history=[U0], xi_history_by_block=xi0,
                   t_history=[float(t_init)])

    def append(self, U_new, xi_by_block, t_new: float) -> None:
        self.U_history.append(np.asarray(U_new).copy())
        for block, xi in xi_by_block.items():
            self.xi_history_by_block[block].append(np.asarray(xi).copy())
        self.t_history.append(float(t_new))

    @property
    def step_idx(self) -> int:
        return len(self.U_history) - 1

    def U_at(self, step: int) -> np.ndarray:
        return self.U_history[step]

    def xi_at(self, step: int, block: str) -> np.ndarray:
        return self.xi_history_by_block[block][step]


def build_fe_problem(
        mesh: Mesh, dof_map: GlobalDofMap, gr: GlobalResidual,
        models_by_block: dict[str, Model],
        modes_by_block: dict[str, GlobalResidualMode] | None = None,
        forcing_fns_by_block_idx: dict[int, Callable] | None = None,
        assembly_quadrature=None, neumann_bcs: Sequence[NeumannBC] = (),
        print_local_convergence: bool = False,
        local_newton_settings: dict[str, Any] | None = None, *,
        dtype: torch.dtype = DEFAULT_DTYPE,
        device: torch.device | str = DEFAULT_DEVICE) -> FEProblem:
    """Validate + build on ``device`` in ``dtype``. Blocks must match the
    mesh partition; each (block, model, mode) binds once via
    ``gr.for_model``. Each model's parameters must live on ``device``."""
    device = checked_device(device)
    if forcing_fns_by_block_idx or neumann_bcs:
        raise NotImplementedError(_NOT_PORTED_LOADS)
    if modes_by_block is None:
        modes_by_block = {b: GlobalResidualMode.CLOSED_FORM
                          for b in models_by_block}
    if assembly_quadrature is None:
        assembly_quadrature = default_assembly_quadrature()

    if set(mesh.element_blocks) != set(models_by_block):
        raise ValueError(
            f"models_by_block keys {sorted(models_by_block)} must match "
            f"mesh.element_blocks keys {sorted(mesh.element_blocks)}")
    if set(modes_by_block) != set(models_by_block):
        raise ValueError("modes_by_block keys must match models_by_block")
    for b, model in models_by_block.items():
        pdev = model.parameters.device
        if torch.device(pdev).type != device.type:
            raise ValueError(
                f"block {b!r}: the model's parameters are on {pdev}, the "
                f"problem on {device}")

    evaluators = {}
    for b, model in models_by_block.items():
        mode = modes_by_block[b]
        evaluators[b] = gr.for_model(
            model, mode=mode,
            local_newton_settings=(local_newton_settings
                                   if mode == GlobalResidualMode.COUPLED
                                   else None),
            print_local_convergence=print_local_convergence)

    return FEProblem(
        mesh=mesh, dof_map=dof_map, gr=gr,
        models_by_block=models_by_block, modes_by_block=modes_by_block,
        evaluators_by_block=evaluators,
        assembly_quadrature=assembly_quadrature, device=device,
        dtype=dtype)
