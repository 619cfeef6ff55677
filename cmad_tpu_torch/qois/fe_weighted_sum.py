"""Composite FE QoI: a weighted sum of registered sub-QoIs.

Port of ``cmad_tpu/qois/fe_weighted_sum.py`` (parity: reference
``cmad/qois/fe_weighted_sum.py``).
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any, ClassVar

from cmad_tpu_torch.io.registry import register_qoi, resolve_qoi
from cmad_tpu_torch.qois.fe_qoi import FEQoI, StepContribution


@register_qoi("fe_weighted_sum")
class FEWeightedSum(FEQoI):
    problem_type: ClassVar[str] = "fe"

    def __init__(self, terms: Sequence[tuple[float, FEQoI]]) -> None:
        if not terms:
            raise ValueError("fe_weighted_sum requires at least one term")
        self._terms = list(terms)

    @classmethod
    def from_deck(cls, qoi_section: dict[str, Any], fe_problem,
                  t_schedule) -> "FEWeightedSum":
        terms = []
        for term in qoi_section["terms"]:
            sub_cls = resolve_qoi(term["name"])
            if sub_cls.problem_type != "fe":
                raise ValueError(
                    f"fe_weighted_sum term {term['name']!r} is not an "
                    f"FE QoI")
            weight = float(term.get("term_weight", 1.0))
            sub_section = {k: v for k, v in term.items()
                           if k != "term_weight"}
            terms.append((weight,
                          sub_cls.from_deck(sub_section, fe_problem,
                                            t_schedule)))
        return cls(terms)

    def step_contribution(self, params_by_block: Mapping[str, dict],
                          fe_arrays) -> StepContribution:
        closures = [(w, q.step_contribution(params_by_block, fe_arrays))
                    for w, q in self._terms]

        def closure(U, U_prev, xi, xi_prev, t, t_prev):
            total = 0.0
            for w, c in closures:
                total = total + w * c(U, U_prev, xi, xi_prev, t, t_prev)
            return total

        return closure
