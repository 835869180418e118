"""Baseline: grandfathered findings the port deliberately keeps.

``baseline.json`` (next to this package) is a list of entries::

    {"rule": "H006", "path": "src/repro_torch/core/types.py",
     "key": "plane-leaf:StackedSegments.row_offset",
     "reason": "why this finding is deliberate"}

Matching is on the stable ``(rule, path, key)`` triple, never on line
numbers, so a baselined finding survives unrelated edits.  Every entry
carries a reason.  Entries that no longer match anything are reported as
*stale* (the finding was fixed: delete the entry); ``--strict-baseline``
fails on them.  The JAX package's ``analysis/baseline.py`` is the
reference.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

from .engine import Finding

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str = DEFAULT_BASELINE) -> List[Dict[str, str]]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        entries = json.load(fh)
    for e in entries:
        missing = {"rule", "path", "key", "reason"} - set(e)
        if missing or not str(e["reason"]).strip():
            raise ValueError(f"baseline entry {e!r} missing "
                             f"{sorted(missing) or ['reason']}")
    return entries


def split_by_baseline(findings: Sequence[Finding],
                      entries: Sequence[Dict[str, str]],
                      ) -> Tuple[List[Finding], List[Finding],
                                 List[Dict[str, str]]]:
    """-> (new_findings, grandfathered, stale_entries)."""
    index = {(e["rule"], e["path"], e["key"]): e for e in entries}
    used = set()
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        k = (f.rule, f.path, f.key)
        if k in index:
            used.add(k)
            old.append(f)
        else:
            new.append(f)
    stale = [e for k, e in index.items() if k not in used]
    return new, old, stale
