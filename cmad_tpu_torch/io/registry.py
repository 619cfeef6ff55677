"""Decorator plugin registries with lazy import-on-resolve.

Port of ``cmad_tpu/io/registry.py`` (parity: reference
``cmad/io/registry.py:54-213``). Registration happens at class definition
via decorators; resolution imports the conventional module of the port
(``cmad_tpu_torch.models.<name>``, ``cmad_tpu_torch.qois.<name>``) on
demand, so importing the io layer has no model-import side effects.
Names are also discoverable
without import through the schema fragments,
``cmad_tpu_torch/io/schemas/<kind>/<name>.yaml`` (the port's copy of the
JAX package's, file for file), read by path. A name with a fragment but
no module in the port yet raises ``NotImplementedError`` naming the
ROADMAP item that ports it (``_NOT_PORTED``); a name with neither raises
``KeyError``.
"""
from __future__ import annotations

import importlib
from collections.abc import Callable
from pathlib import Path

_MODEL_REGISTRY: dict[str, type] = {}
_QOI_REGISTRY: dict[str, type] = {}
_GLOBAL_RESIDUAL_REGISTRY: dict[str, type] = {}

_SCHEMA_DIR = Path(__file__).resolve().parent / "schemas"

# (schema subdirectory, name) -> the ROADMAP queue 1 item that ports it,
# for every name the schema copy advertises whose module the port lacks
_NOT_PORTED = {
    ("qois", "calibration"): 23,
    ("qois", "uniaxial_calibration"): 23,
}


def _register(registry: dict[str, type], name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        registry[name] = cls
        return cls
    return deco


def _resolve(registry: dict[str, type], name: str, package: str,
             kind: str, subdir: str) -> type:
    if name not in registry:
        module = f"{package}.{name}"
        try:
            importlib.import_module(module)
        except ImportError as e:
            if (getattr(e, "name", None) == module
                    and (_SCHEMA_DIR / subdir / f"{name}.yaml").is_file()):
                raise NotImplementedError(
                    f"{kind} {name!r} is in the schema but not ported "
                    f"yet: ROADMAP queue 1, item "
                    f"{_NOT_PORTED[(subdir, name)]}") from e
            raise KeyError(
                f"no registered {kind} named {name!r} "
                f"(import of {module} failed: {e})") from e
    try:
        return registry[name]
    except KeyError as e:
        raise KeyError(
            f"module for {kind} {name!r} imported but did not register "
            f"the name") from e


def _registered_names(registry: dict[str, type], subdir: str) -> list[str]:
    """Names discoverable without import: registered + schema fragments."""
    names = set(registry)
    frag_dir = _SCHEMA_DIR / subdir
    if frag_dir.is_dir():
        names.update(p.stem for p in frag_dir.glob("*.yaml"))
    return sorted(names)


def register_model(name: str):
    return _register(_MODEL_REGISTRY, name)


def resolve_model(name: str) -> type:
    return _resolve(_MODEL_REGISTRY, name, "cmad_tpu_torch.models", "model",
                    "models")


def registered_model_names() -> list[str]:
    return _registered_names(_MODEL_REGISTRY, "models")


def register_qoi(name: str):
    return _register(_QOI_REGISTRY, name)


def resolve_qoi(name: str) -> type:
    return _resolve(_QOI_REGISTRY, name, "cmad_tpu_torch.qois", "qoi", "qois")


def registered_qoi_names() -> list[str]:
    return _registered_names(_QOI_REGISTRY, "qois")


def register_global_residual(name: str):
    return _register(_GLOBAL_RESIDUAL_REGISTRY, name)


def resolve_global_residual(name: str) -> type:
    return _resolve(_GLOBAL_RESIDUAL_REGISTRY, name,
                    "cmad_tpu_torch.global_residuals", "global residual",
                    "global_residuals")


def registered_global_residual_names() -> list[str]:
    return _registered_names(_GLOBAL_RESIDUAL_REGISTRY, "global_residuals")
