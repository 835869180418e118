"""Data-plane reachability call graph for H003/H005.

The port compiles nothing, so it has no ``jit`` to root the walk at.
Its roots are the functions a search enters the device through:

- every runner handed to ``register_scan_plane`` (the ScanPlane registry
  is how the kernels reach the planner without a direct call), as in the
  JAX package;
- ``ENTRY_POINTS``: the module-level data-plane entry functions (the
  planner's stages, the cascade factory, the residency plan, the store's
  re-rank and the kernel wrappers).  A listed root that no longer
  resolves is a finding (``unresolved_roots``), so a rename cannot drop
  a function out of the walk unseen.

From the roots the walk follows *reference* edges, and nested ``def``s
inherit reachability from their enclosing function (closures such as
the cascade runner).  References resolve through real import structure,
never by bare name collision:

- a bare ``Name`` that is not locally bound resolves to a same-file
  function of that name, or through a ``from M import n`` binding to the
  module-level ``n`` in M's file;
- an ``Attribute`` chain (``scan.blocksoa_scan``, ``a.b.f``) resolves its
  root through ``import``/``from``-aliases to a project module, then to
  the module-level function; chains rooted at locals (``self.step``,
  ``entry.get``) resolve to nothing.

Methods are reachable only through a nested-def edge: the store's search
methods are held at run time instead (``analysis.sanitize``).  The walk
stops at ``SANCTIONED``: ``sanitize.fetch`` is the one sanctioned
device-to-host read, and its body is not data-plane code.

The JAX package's ``analysis/callgraph.py`` is the reference.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .engine import Project, SourceFile, dotted_name

#: The module-level data-plane entry functions, by dotted name.
ENTRY_POINTS = (
    "repro_torch.core.planner.search",
    "repro_torch.core.planner.search_stacked",
    "repro_torch.core.planner.static_route",
    "repro_torch.core.planner.probe_plan",
    "repro_torch.core.planner.search_stacked_sharded",
    "repro_torch.core.planner.project_probes",
    "repro_torch.core.planner.candidate_stage",
    "repro_torch.core.cascade.make_cascade_runner",
    "repro_torch.core.residency.device_plan",
    "repro_torch.core.store._rerank_pool",
    "repro_torch.kernels.fused_select.fused_scan_select",
    "repro_torch.kernels.hntl_scan.hntl_scan_single",
    "repro_torch.kernels.hntl_scan.hntl_scan",
)

#: The package whose presence in a run makes every entry point required.
ROOT_PACKAGE = "repro_torch"

#: Modules the walk never enters: the runtime guard's sanctioned reads.
SANCTIONED = ("repro_torch.analysis.sanitize",)


@dataclasses.dataclass
class FuncInfo:
    path: str
    qualname: str
    name: str
    node: ast.AST                 # FunctionDef | AsyncFunctionDef
    is_method: bool               # defined directly inside a ClassDef
    reachable: bool = False
    children: List["FuncInfo"] = dataclasses.field(default_factory=list)
    name_refs: Set[str] = dataclasses.field(default_factory=set)
    attr_chains: Set[str] = dataclasses.field(default_factory=set)
    bound: Set[str] = dataclasses.field(default_factory=set)


class CallGraph:
    def __init__(self, funcs: List[FuncInfo], unresolved: List[str],
                 entry_file: Optional[str]):
        self.funcs = funcs
        #: ENTRY_POINTS that name no function of the run's package
        self.unresolved_roots = unresolved
        #: the file an unresolved root is reported against
        self.entry_file = entry_file

    def reachable_funcs(self) -> List[FuncInfo]:
        return [f for f in self.funcs if f.reachable]


def module_of(path: str) -> str:
    """``src/repro_torch/core/scan.py`` -> ``repro_torch.core.scan``.

    Everything up to the last ``src`` directory is dropped, so a copy of
    the package under another root maps to the same module names."""
    p = path[:-3] if path.endswith(".py") else path
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    parts = p.split("/")
    if "src" in parts:
        parts = parts[len(parts) - parts[::-1].index("src"):]
    return ".".join(parts)


def _import_table(sf: SourceFile) -> Dict[str, str]:
    """Local name -> dotted target (module, or module.symbol).

    Handles absolute and relative imports; ``import a.b.c`` binds ``a``
    and the full chain is resolved by prefix at lookup time."""
    mod_parts = module_of(sf.path).split(".")
    if not sf.path.endswith("__init__.py"):
        mod_parts = mod_parts[:-1]            # the file's package
    table: Dict[str, str] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    table[a.asname] = a.name
                else:
                    table[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = mod_parts[: len(mod_parts) - (node.level - 1)]
                prefix = ".".join(base + ([node.module] if node.module
                                          else []))
            else:
                prefix = node.module or ""
            for a in node.names:
                local = a.asname or a.name
                table[local] = f"{prefix}.{a.name}" if prefix else a.name
    return table


def _registered_runner_refs(sf: SourceFile) -> List[ast.AST]:
    """The runner expressions handed to ``register_scan_plane(...)``.

    ``register_scan_plane("x", KIND, runner, ...)``: the runner may be a
    Name (``fused_scan_select``), a module Attribute
    (``scan.blocksoa_scan``) or a factory Call
    (``cascade.make_cascade_runner("kernel")``); for a factory the
    *factory* becomes the root and its closure is reached via the
    nested-def edge."""
    out: List[ast.AST] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = dotted_name(node.func)
        if fn is None or fn.split(".")[-1] != "register_scan_plane":
            continue
        runner = node.args[2] if len(node.args) >= 3 else next(
            (k.value for k in node.keywords if k.arg == "runner"), None)
        if isinstance(runner, ast.Call):
            runner = runner.func
        if runner is not None:
            out.append(runner)
    return out


class _Collector(ast.NodeVisitor):
    """Collect every function def with its nesting and identifier refs."""

    def __init__(self, sf: SourceFile, funcs: List[FuncInfo]):
        self.sf = sf
        self.funcs = funcs
        self.scope: List[str] = []
        self.stack: List[FuncInfo] = []
        self.class_depth_at: List[int] = []

    def _visit_def(self, node) -> None:
        qual = ".".join(self.scope + [node.name]) or node.name
        in_class = bool(self.class_depth_at) and \
            self.class_depth_at[-1] == len(self.scope)
        fi = FuncInfo(path=self.sf.path, qualname=qual, name=node.name,
                      node=node, is_method=in_class)
        args = node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)
                  + [x for x in (args.vararg, args.kwarg) if x]):
            fi.bound.add(a.arg)
        if self.stack:
            self.stack[-1].children.append(fi)
        self.funcs.append(fi)
        self.scope.append(node.name)
        self.stack.append(fi)
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.stack.pop()
        self.scope.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope.append(node.name)
        self.class_depth_at.append(len(self.scope))
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.class_depth_at.pop()
        self.scope.pop()

    def visit_Name(self, node: ast.Name) -> None:
        if self.stack:
            if isinstance(node.ctx, ast.Store):
                self.stack[-1].bound.add(node.id)
            else:
                self.stack[-1].name_refs.add(node.id)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.stack:
            dn = dotted_name(node)
            if dn is not None:
                self.stack[-1].attr_chains.add(dn)
        self.generic_visit(node)


def build(project: Project) -> CallGraph:
    funcs: List[FuncInfo] = []
    imports: Dict[str, Dict[str, str]] = {}
    for sf in project.files:
        _Collector(sf, funcs).visit(sf.tree)
        imports[sf.path] = _import_table(sf)

    # module-level (non-method) functions by (module, name); same-file
    # functions (any nesting) by (path, name)
    module_funcs: Dict[Tuple[str, str], List[FuncInfo]] = {}
    file_funcs: Dict[Tuple[str, str], List[FuncInfo]] = {}
    module_files = {module_of(sf.path) for sf in project.files}
    for fi in funcs:
        if not fi.is_method:
            file_funcs.setdefault((fi.path, fi.name), []).append(fi)
            if "." not in fi.qualname:
                module_funcs.setdefault((module_of(fi.path), fi.name),
                                        []).append(fi)

    def resolve_name(path: str, name: str) -> List[FuncInfo]:
        out = list(file_funcs.get((path, name), ()))
        full = imports[path].get(name)
        if full and "." in full:
            mod, sym = full.rsplit(".", 1)
            out.extend(module_funcs.get((mod, sym), ()))
        return out

    def resolve_chain(path: str, chain: str) -> List[FuncInfo]:
        parts = chain.split(".")
        root = imports[path].get(parts[0], parts[0])
        full = ".".join([root] + parts[1:])
        if "." not in full:
            return []
        mod, sym = full.rsplit(".", 1)
        # `from pkg import mod` aliases can themselves be modules
        if mod in module_files or root in module_files:
            return list(module_funcs.get((mod, sym), ()))
        return []

    def resolve(cur: FuncInfo) -> List[FuncInfo]:
        targets: List[FuncInfo] = list(cur.children)
        for name in cur.name_refs:
            if name not in cur.bound:
                targets.extend(resolve_name(cur.path, name))
        for chain in cur.attr_chains:
            if chain.split(".")[0] not in cur.bound:
                targets.extend(resolve_chain(cur.path, chain))
        return targets

    roots: List[FuncInfo] = []
    for sf in project.files:
        for ref in _registered_runner_refs(sf):
            dn = dotted_name(ref)
            if dn is None:
                continue
            roots.extend(resolve_name(sf.path, dn) if "." not in dn
                         else resolve_chain(sf.path, dn))
    unresolved: List[str] = []
    entry_file = None
    if ROOT_PACKAGE in module_files:
        entry_file = next(sf.path for sf in project.files
                          if module_of(sf.path) == ROOT_PACKAGE)
        for dotted in ENTRY_POINTS:
            mod, sym = dotted.rsplit(".", 1)
            hit = module_funcs.get((mod, sym), ())
            if not hit:
                unresolved.append(dotted)
            roots.extend(hit)

    worklist = [f for f in roots if module_of(f.path) not in SANCTIONED]
    for f in worklist:
        f.reachable = True
    while worklist:
        cur = worklist.pop()
        for t in resolve(cur):
            if not t.reachable and module_of(t.path) not in SANCTIONED:
                t.reachable = True
                worklist.append(t)
    return CallGraph(funcs, unresolved, entry_file)
