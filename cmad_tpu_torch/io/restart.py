"""FE checkpoint/restart artifacts.

Port of ``cmad_tpu/io/restart.py``; the file format is the same, so
either package resumes from the other's checkpoint.

A restart file is one ``.npz`` holding the final converged state of a
quasi-static drive: the displacement vector, every block's per-IP local
state, and the time it was recorded at. ``cmad primal`` writes one when
the deck's output section sets ``write restart: true`` and resumes from
one named in a top-level ``restart: {file: ...}`` section.

This is a capability the reference lacks (SURVEY.md section 5:
checkpoint/resume "ABSENT as a restart facility ... no CLI
restart-from-file path exists"); the underlying restartability of the
time loop is proven by the JAX package's drive-restart tests. Exodus
output cannot serve this role: element state is written IP-averaged
(lossy), while a bitwise-exact resume needs the raw per-IP xi.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_XI_PREFIX = "xi__"


def write_restart(path: Path, U: np.ndarray,
                  xi_by_block: dict[str, np.ndarray], t: float) -> None:
    """Write one converged state as a restart checkpoint."""
    payload: dict[str, np.ndarray] = {
        "U": np.asarray(U), "t": np.asarray(float(t))}
    for block, xi in xi_by_block.items():
        payload[_XI_PREFIX + block] = np.asarray(xi)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **payload)


def read_restart(path: Path):
    """Load ``(U, xi_by_block, t)`` from a restart checkpoint."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"restart file not found: {path}")
    with np.load(path) as data:
        if "U" not in data or "t" not in data:
            raise ValueError(
                f"{path} is not a cmad restart file (missing U/t)")
        U = np.asarray(data["U"])
        t = float(data["t"])
        xi_by_block = {
            key[len(_XI_PREFIX):]: np.asarray(data[key])
            for key in data.files if key.startswith(_XI_PREFIX)}
    if not xi_by_block:
        raise ValueError(
            f"{path} carries no per-block state (xi__<block> arrays)")
    return U, xi_by_block, t


def check_restart_compatible(fe_problem, U, xi_by_block) -> None:
    """Eager shape validation with actionable messages."""
    n_dofs = fe_problem.dof_map.num_total_dofs
    if U.shape != (n_dofs,):
        raise ValueError(
            f"restart U has shape {U.shape}; the deck's problem has "
            f"{n_dofs} dofs — mesh or discretization mismatch")
    blocks = set(fe_problem.models_by_block)
    if set(xi_by_block) != blocks:
        raise ValueError(
            f"restart blocks {sorted(xi_by_block)} do not match the "
            f"deck's element blocks {sorted(blocks)}")
    for block, model in fe_problem.models_by_block.items():
        n_elems = len(fe_problem.mesh.element_blocks[block])
        expected = (n_elems, fe_problem.num_ips(), model.num_dofs)
        if xi_by_block[block].shape != expected:
            raise ValueError(
                f"restart xi for block {block!r} has shape "
                f"{xi_by_block[block].shape}; expected {expected} — "
                "model or quadrature mismatch")
