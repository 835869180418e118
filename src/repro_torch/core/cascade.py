"""Mixed-precision cascade select stage.

Only the budget validation is ported so far; the staged planes
("cascade", "cascade_ref") are not registered yet, so any ``budgets=``
reaching the planner is refused there.
"""
from __future__ import annotations


def check_budgets(budgets, topk: int) -> None:
    """Host-side validation of per-stage survivor budgets ``(b1, b2)``."""
    if budgets is None:
        return
    if len(budgets) != 2:
        raise ValueError(f"budgets must be (b1, b2), got {budgets!r}")
    b1, b2 = int(budgets[0]), int(budgets[1])
    if not b1 >= b2 >= 1:
        raise ValueError(
            f"stage budgets must satisfy b1 >= b2 >= 1, got {budgets!r}")
    if b2 < topk:
        raise ValueError(
            f"final-stage survivor budget {b2} < topk {topk}: the exact "
            "re-rank could never fill the result; raise b2 or lower topk")
