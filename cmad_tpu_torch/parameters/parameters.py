"""Calibration-parameter container: values + active flags + transforms.

Port of ``cmad_tpu/parameters/parameters.py``. A ``Parameters`` holds
three parallel nested dicts:

- ``values``: nested dict of tensors (the physical parameters)
- ``active_flags``: same structure, bool per leaf (arrays share one flag)
- ``transforms``: same structure; each leaf is ``None`` (identity),
  ``[lo, hi]`` (affine map from canonical [-1, 1]), or ``[ref]``
  (log map: physical = ref * exp(canonical)).

The flat order is the JAX package's ``ravel_pytree`` order: dict keys
sorted at every level, so the J2+Voce active vector is ``[D, S, Y]``.
Every tensor lives on the ``device`` and in the ``dtype`` the container
was built with; :meth:`tree_with_flat_active` is differentiable, so a
whole objective can be differentiated with respect to the flat vector.
"""
from __future__ import annotations

from itertools import chain
from typing import Any

import numpy as np
import torch

from cmad_tpu_torch.config import DEFAULT_DEVICE, DEFAULT_DTYPE, checked_device
from cmad_tpu_torch.typing import (
    ActiveFlags,
    Params,
    PyTree,
    Tensor,
    Transform,
    Transforms,
)

# transform kind codes used in the vectorized tables
_IDENTITY, _BOUNDS, _LOG = 0, 1, 2


def bounds_transform(value, bounds, transform_from_canonical=True):
    """Affine map between canonical [-1, 1] and [lo, hi]."""
    span = 0.5 * (bounds[1] - bounds[0])
    mean = 0.5 * (bounds[0] + bounds[1])
    if transform_from_canonical:
        return span * value + mean
    return float(np.clip((value - mean) / span, -1.0, 1.0))


def log_transform(value, ref_value, transform_from_canonical=True):
    """Log map: physical = ref * exp(canonical)."""
    if transform_from_canonical:
        if not isinstance(value, Tensor):
            value = torch.tensor(value, dtype=torch.float64)
        return ref_value[0] * torch.exp(value)
    return float(np.log(value / ref_value[0]))


def _leaves_with_path(tree: PyTree, path: tuple = ()):
    """(path, leaf) pairs in ``jax.tree_util`` order: dict keys sorted at
    every level; anything that is not a dict is a leaf (so a transform's
    ``[lo, hi]`` pair stays one leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def _leaves(tree: PyTree) -> list:
    return [leaf for _p, leaf in _leaves_with_path(tree)]


def _tree_map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unflatten(paths: list[tuple], leaves: list) -> Params:
    out: dict[str, Any] = {}
    for path, leaf in zip(paths, leaves, strict=True):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _leaf_size(x) -> int:
    if isinstance(x, (float, int, np.floating)):
        return 1
    if isinstance(x, Tensor):
        return x.numel()
    return int(np.size(x))


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _expand_by_value_size(values: PyTree, tree: PyTree) -> list:
    """Repeat each leaf of ``tree`` once per element of the matching
    ``values`` leaf (array leaves share a single flag/transform)."""
    expanded = [[leaf] * _leaf_size(v)
                for v, leaf in zip(_leaves(values), _leaves(tree),
                                   strict=True)]
    return list(chain.from_iterable(expanded))


def _transform_kind(t: Transform) -> int:
    if t is None:
        return _IDENTITY
    if len(t) == 2:
        return _BOUNDS
    if len(t) == 1:
        return _LOG
    raise ValueError(f"unexpected transform shape: {t}")


class Parameters:
    """Nested-dict parameter container with canonical-space machinery."""

    def __init__(
            self, values: Params,
            active_flags: ActiveFlags | None = None,
            transforms: Transforms | None = None,
            *, dtype: torch.dtype = DEFAULT_DTYPE,
            device: torch.device | str = DEFAULT_DEVICE,
    ) -> None:
        self.dtype = dtype
        self.device = checked_device(device)

        def as_leaf(x) -> Tensor:
            if isinstance(x, Tensor):
                return x.to(dtype=dtype, device=self.device)
            return torch.tensor(np.asarray(x, dtype=np.float64),
                                dtype=dtype, device=self.device)

        self.values: Params = _tree_map(as_leaf, values)
        self._active_flags = active_flags
        self._transforms = transforms

        pairs = list(_leaves_with_path(self.values))
        self._paths = [p for p, _v in pairs]
        self._shapes = [v.shape for _p, v in pairs]
        self._flat_values = self._ravel(self.values)
        self.num_params = int(self._flat_values.numel())

        self._names = [f"[{p[-1]!r}]" for p in self._paths]
        self.flat_param_sizes = [_leaf_size(v) for v in _leaves(values)]

        if active_flags is None:
            assert transforms is None, \
                "active_flags must be supplied when transforms is set"
            self.num_active_params = 0
            self.active_idx = np.zeros(0, dtype=np.intp)
            return

        assert transforms is not None, \
            "transforms must be supplied when active_flags is set"

        flat_flags = np.array(
            _expand_by_value_size(values, active_flags), dtype=bool)
        self._flat_active_flags = flat_flags
        self.active_idx = np.arange(self.num_params)[flat_flags]
        self.num_active_params = int(flat_flags.sum())

        self._flat_transforms: list[Transform] = \
            _expand_by_value_size(values, transforms)
        self._flat_active_transforms = [
            self._flat_transforms[i] for i in self.active_idx]

        # vectorized transform tables over the active entries
        kinds = np.array([_transform_kind(t)
                          for t in self._flat_active_transforms])
        self._active_kinds = kinds
        span = np.ones(self.num_active_params)
        mean = np.zeros(self.num_active_params)
        ref = np.ones(self.num_active_params)
        for i, t in enumerate(self._flat_active_transforms):
            if kinds[i] == _BOUNDS:
                span[i] = 0.5 * (t[1] - t[0])
                mean[i] = 0.5 * (t[1] + t[0])
            elif kinds[i] == _LOG:
                ref[i] = t[0]
        self._span, self._mean, self._ref = span, mean, ref

        # scipy.optimize bounds in canonical space: [-1, 1] for bounds
        # transforms, unbounded otherwise
        self.opt_bounds = np.array([
            [-1.0, 1.0] if k == _BOUNDS else [None, None] for k in kinds],
            dtype=object)

    # ------------------------------------------------------------------
    # flat <-> nested (the ravel_pytree pair)
    # ------------------------------------------------------------------
    @staticmethod
    def _ravel(values: Params) -> Tensor:
        return torch.cat([v.reshape(-1) for v in _leaves(values)])

    def reconstruct_from_flat(self, flat: Tensor) -> Params:
        sizes = [int(np.prod(s)) for s in self._shapes]
        parts = torch.split(flat, sizes)
        return _unflatten(self._paths, [
            p.reshape(s) for p, s in zip(parts, self._shapes, strict=True)])

    # ------------------------------------------------------------------
    # differentiable canonical/physical conversions (vectorized)
    # ------------------------------------------------------------------
    def physical_from_canonical_active(self, a) -> Tensor:
        """Vector of physical values from canonical active values."""
        if not isinstance(a, Tensor):
            a = torch.tensor(_to_numpy(a), dtype=self.dtype)
        k = torch.as_tensor(self._active_kinds, device=a.device)
        span = torch.as_tensor(self._span, dtype=a.dtype, device=a.device)
        mean = torch.as_tensor(self._mean, dtype=a.dtype, device=a.device)
        ref = torch.as_tensor(self._ref, dtype=a.dtype, device=a.device)
        # double-where: exp() must see only log-transformed entries, or a
        # large physical value in an identity slot overflows in the
        # unselected branch and its reverse-mode cotangent turns 0 * inf
        # into NaN
        a_log = torch.where(k == _LOG, a, torch.zeros_like(a))
        out = torch.where(k == _BOUNDS, span * a + mean, a)
        return torch.where(k == _LOG, ref * torch.exp(a_log), out)

    def tree_with_flat_active(self, a, canonical: bool = False) -> Params:
        """Rebuild the full params dict with active entries replaced by
        ``a`` (canonical or physical). Differentiable: the gradient of a
        function of this dict with respect to ``a`` is the transformed
        gradient."""
        a = torch.as_tensor(a, dtype=self._flat_values.dtype,
                            device=self._flat_values.device)
        if canonical:
            a = self.physical_from_canonical_active(a)
        idx = torch.as_tensor(self.active_idx, device=a.device)
        flat = self._flat_values.index_copy(0, idx, a)
        return self.reconstruct_from_flat(flat)

    # reference-parity alias (cmad/parameters/parameters.py:384)
    def get_params_pytree_from_flat_canonical_active(self, a) -> Params:
        return self.tree_with_flat_active(a, canonical=True)

    # ------------------------------------------------------------------
    # host-side state management
    # ------------------------------------------------------------------
    def set_rotation_matrix(self, rotation_matrix) -> None:
        self.values["rotation matrix"] = torch.tensor(
            _to_numpy(rotation_matrix), dtype=self.dtype, device=self.device)
        self._flat_values = self._ravel(self.values)

    def set_active_values_from_flat(
            self, flat_active_values, are_canonical: bool = True) -> None:
        a = _to_numpy(flat_active_values).astype(np.float64)
        if are_canonical:
            a = _to_numpy(self.physical_from_canonical_active(
                torch.as_tensor(a)))
        flat = _to_numpy(self._flat_values).copy()
        flat[self.active_idx] = a
        self.values = self.reconstruct_from_flat(torch.as_tensor(
            flat, dtype=self.dtype, device=self.device))
        self._flat_values = self._ravel(self.values)

    def flat_active_values(self, return_canonical: bool = False) -> np.ndarray:
        active = _to_numpy(self._ravel(self.values))[self.active_idx]
        if not return_canonical:
            return active
        out = np.empty_like(active)
        for i, (v, t) in enumerate(
                zip(active, self._flat_active_transforms, strict=True)):
            k = _transform_kind(t)
            if k == _BOUNDS:
                out[i] = bounds_transform(v, t, transform_from_canonical=False)
            elif k == _LOG:
                out[i] = log_transform(v, t, transform_from_canonical=False)
            else:
                out[i] = v
        return out

    def get_active_from_flat(self, tree: PyTree) -> np.ndarray:
        flat = np.concatenate([_to_numpy(v).reshape(-1)
                               for v in _leaves(tree)])
        return flat[self.active_idx]

    # ------------------------------------------------------------------
    # post-hoc chain-rule transforms (vectorized; parity with reference
    # transform_grad / transform_hessian at parameters.py:326,334)
    # ------------------------------------------------------------------
    def _deriv_factors(self) -> tuple[np.ndarray, np.ndarray]:
        """(first, second) canonical-derivative factors at the current
        active physical values: d(phys)/d(canon) and d2(phys)/d(canon)2."""
        v = self.flat_active_values()
        k = self._active_kinds
        first = np.where(k == _BOUNDS, self._span,
                         np.where(k == _LOG, v, 1.0))
        second = np.where(k == _LOG, v, 0.0)
        return first, second

    def transform_grad(self, grad) -> np.ndarray:
        """Physical-space gradient -> canonical-space gradient."""
        first, _ = self._deriv_factors()
        return _to_numpy(grad) * first

    def transform_hessian(self, hessian, grad) -> np.ndarray:
        """Physical-space (H, g) -> canonical-space Hessian."""
        first, second = self._deriv_factors()
        H = _to_numpy(hessian) * np.outer(first, first)
        return H + np.diag(_to_numpy(grad) * second)

    # ------------------------------------------------------------------
    # jacobian helpers for model/qoi derivative surfaces
    # ------------------------------------------------------------------
    def active_params_jacobian(
            self, jac_tree: PyTree, num_rows: int) -> Tensor:
        """Flatten a jacobian-w.r.t.-params dict (one leaf per parameter,
        leading axis ``num_rows``) to a dense (num_rows, n_active)
        matrix. Parity: parameters.py:384 _active_params_jacobian."""
        full = torch.cat([x.reshape(num_rows, -1)
                          for x in _leaves(jac_tree)], dim=1)
        idx = torch.as_tensor(self.active_idx, device=full.device)
        return full[:, idx]

    def scalar_active_params_jacobian(self, jac_tree: PyTree) -> Tensor:
        return self.active_params_jacobian(jac_tree, 1)


def parameters_from_numpy(values: Params, flags: ActiveFlags | None = None,
                          transforms: Transforms | None = None, *,
                          dtype: torch.dtype,
                          device: torch.device | str) -> Parameters:
    """The port's :class:`Parameters` from the JAX package's trees as
    numpy (``jax.tree.map(np.asarray, p.values)``) or plain Python
    numbers, on an explicit ``device`` in an explicit ``dtype``."""
    return Parameters(values, flags, transforms, dtype=dtype, device=device)
