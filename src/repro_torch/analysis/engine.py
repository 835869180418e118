"""Rule engine: file walking, parsing, pragma suppression, orchestration.

This package's own copy of the JAX package's ``analysis/engine.py``: the
same ``Finding`` keys, the same pragma syntax (``# hntlint: ok H004``, so
one pragma serves both linters) and the same directory walk.  Beside the
Python files, a run also reads the kernels' CUDA sources (``.cu``,
``.cuh``) as text, for the one rule that applies to them (H004).

The engine is stdlib-only (``ast`` + ``tokenize``): the lint gate runs
anywhere the repo checks out, and never imports torch or the package
under analysis.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set

#: Directory names never descended into when walking a directory argument.
#: ``lint_corpus`` holds deliberately-violating fixtures for the JAX
#: linter's own test suite; explicit file arguments bypass the skip.
SKIP_DIRS = ("__pycache__", "lint_corpus")

#: Suffixes of the kernel sources read as text (not parsed).
TEXT_SUFFIXES = (".cu", ".cuh")

PRAGMA_TAG = "hntlint:"

_C_PRAGMA = re.compile(r"//\s*hntlint:\s*ok\b([^\n]*)", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``key`` is the finding's *stable identity* for baseline matching:
    derived from symbol/scope names, never from line numbers, so a
    baselined finding survives unrelated edits above it.
    """

    rule: str
    path: str
    line: int
    col: int
    message: str
    key: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class SourceFile:
    """A parsed source file plus its pragma table."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.pragmas = collect_pragmas(source)

    def suppressed(self, rule: str, line: int) -> bool:
        ids = self.pragmas.get(line)
        return ids is not None and ("*" in ids or rule in ids)


class TextFile:
    """A kernel source read as text, with ``// hntlint: ok`` pragmas."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.pragmas: Dict[int, Set[str]] = {}
        for n, line in enumerate(source.splitlines(), start=1):
            m = _C_PRAGMA.search(line)
            if m:
                self.pragmas[n] = _pragma_ids(m.group(1))

    suppressed = SourceFile.suppressed


class Project:
    """All files of one analysis run + lazily-built shared passes."""

    def __init__(self, files: Sequence[SourceFile],
                 texts: Sequence[TextFile] = ()):
        self.files = list(files)
        self.texts = list(texts)
        self.by_path: Dict[str, object] = {f.path: f for f in self.files}
        self.by_path.update({t.path: t for t in self.texts})
        self._callgraph = None

    @property
    def callgraph(self):
        if self._callgraph is None:
            from . import callgraph
            self._callgraph = callgraph.build(self)
        return self._callgraph


def _pragma_ids(ids: str) -> Set[str]:
    ids = ids.strip()
    if not ids:
        return {"*"}
    return {rid.upper() for rid in ids.replace(",", " ").split()}


def collect_pragmas(source: str) -> Dict[int, Set[str]]:
    """Map line -> suppressed rule ids ("*" = all) from hntlint comments.

    Syntax: ``# hntlint: ok H004`` / ``# hntlint: ok H004, H006`` /
    ``# hntlint: ok`` (suppress every rule on the line).
    """
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            text = tok.string.lstrip("#").strip()
            if not text.lower().startswith(PRAGMA_TAG):
                continue
            rest = text[len(PRAGMA_TAG):].strip()
            if not (rest == "ok" or rest.lower().startswith("ok ")):
                continue
            out.setdefault(tok.start[0], set()).update(_pragma_ids(rest[2:]))
    except tokenize.TokenError:
        pass
    return out


def _walk(paths: Iterable[str], suffixes: Sequence[str]) -> List[str]:
    """Sorted, de-duplicated relative paths: a path given as a *file* is
    taken whatever its suffix, a directory is walked for ``suffixes``,
    skipping ``SKIP_DIRS`` and hidden directories."""
    seen: Set[str] = set()
    out: List[str] = []

    def add(p: str) -> None:
        rel = os.path.relpath(p).replace(os.sep, "/")
        if rel not in seen:
            seen.add(rel)
            out.append(rel)

    for p in paths:
        if os.path.isfile(p):
            add(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in SKIP_DIRS and not d.startswith("."))
            for n in sorted(names):
                if n.endswith(tuple(suffixes)):
                    add(os.path.join(root, n))
    return out


def collect_files(paths: Iterable[str]) -> List[str]:
    """Expand path arguments into a sorted, de-duplicated .py file list,
    as the JAX package's ``collect_files`` does (an explicit file is how
    the fixture tests feed files in)."""
    return _walk(paths, (".py",))


def collect_texts(paths: Iterable[str]) -> List[str]:
    """The kernel sources (``TEXT_SUFFIXES``) under the directories among
    the path arguments."""
    return _walk([p for p in paths if not os.path.isfile(p)], TEXT_SUFFIXES)


def load_project(paths: Iterable[str]) -> Project:
    paths = list(paths)
    files, texts = [], []
    for path in collect_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        if path.endswith(TEXT_SUFFIXES):
            texts.append(TextFile(path, source))
        else:
            files.append(SourceFile(path, source))
    for path in collect_texts(paths):
        with open(path, "r", encoding="utf-8") as fh:
            texts.append(TextFile(path, fh.read()))
    return Project(files, texts)


def analyze_paths(paths: Iterable[str],
                  rules: Optional[Sequence] = None) -> List[Finding]:
    """Run all (or the given) rules over the paths; pragma-filtered."""
    from . import rules as rules_mod
    project = load_project(paths)
    active = rules_mod.ALL_RULES if rules is None else rules
    findings: List[Finding] = []
    for rule in active:
        findings.extend(rule(project))
    findings = [f for f in findings
                if f.path not in project.by_path
                or not project.by_path[f.path].suppressed(f.rule, f.line)]
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def scope_map(tree: ast.AST) -> Dict[int, str]:
    """Map id(node) -> dotted qualname of the enclosing scope.

    Module scope is ``"<module>"``; nested defs join with ``"."``
    (``Cls.method``, ``outer.inner``).  Used for stable Finding keys."""
    out: Dict[int, str] = {}

    def visit(node: ast.AST, scope: str) -> None:
        for child in ast.iter_child_nodes(node):
            out[id(child)] = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                inner = child.name if scope == "<module>" \
                    else f"{scope}.{child.name}"
                visit(child, inner)
            else:
                visit(child, scope)

    out[id(tree)] = "<module>"
    visit(tree, "<module>")
    return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
