"""Decorator plugin registries with lazy import-on-resolve.

Port of ``cmad_tpu/io/registry.py`` (parity: reference
``cmad/io/registry.py:54-213``). Registration happens at class definition
via decorators; resolution imports the conventional module of the port
(``cmad_tpu_torch.models.<name>``) on demand, so importing the io layer
has no model-import side effects. The QoI and global-residual
registries come with those slices. Names are also discoverable
without import through the schema fragments, which both packages share
as data: ``cmad_tpu/io/schemas/<kind>/<name>.yaml``, read by path.
"""
from __future__ import annotations

import importlib
from collections.abc import Callable
from pathlib import Path

_MODEL_REGISTRY: dict[str, type] = {}

_SCHEMA_DIR = Path(__file__).resolve().parents[2] / "cmad_tpu" / "io" \
    / "schemas"


def _register(registry: dict[str, type], name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        registry[name] = cls
        return cls
    return deco


def _resolve(registry: dict[str, type], name: str, package: str,
             kind: str) -> type:
    if name not in registry:
        module = f"{package}.{name}"
        try:
            importlib.import_module(module)
        except ImportError as e:
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
    return _resolve(_MODEL_REGISTRY, name, "cmad_tpu_torch.models", "model")


def registered_model_names() -> list[str]:
    return _registered_names(_MODEL_REGISTRY, "models")
