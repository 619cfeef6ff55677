"""Deformation (drive) types for material-point problems.

Port of ``cmad_tpu/models/deformation_types.py`` (parity: reference
``cmad/models/deformation_types.py``).
"""
from enum import IntEnum


class DefType(IntEnum):
    FULL_3D = 0
    PLANE_STRAIN = 1
    PLANE_STRESS = 2
    UNIAXIAL_STRESS = 3
    PURE_SHEAR = 4


_NDIMS = {
    DefType.FULL_3D: 3,
    DefType.PLANE_STRAIN: 2,
    DefType.PLANE_STRESS: 2,
    DefType.UNIAXIAL_STRESS: 1,
    DefType.PURE_SHEAR: 1,
}


def def_type_ndims(def_type: int) -> int:
    try:
        return _NDIMS[DefType(def_type)]
    except (ValueError, KeyError) as e:
        raise NotImplementedError(f"unknown def_type: {def_type}") from e


def def_type_from_name(name: str) -> DefType:
    try:
        return DefType[name.upper()]
    except KeyError as e:
        raise ValueError(f"unknown deformation type: {name!r}") from e
