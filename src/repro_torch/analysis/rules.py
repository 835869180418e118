"""The H001–H007 rule set, restated for PyTorch.

Each rule is ``rule(project) -> list[Finding]``.  Keys (baseline
identities) are built from symbol/scope names only; see engine.Finding.
The ids are the JAX package's (``analysis/rules.py``), so one pragma
serves both linters:

  H001  no tensor made at module scope: it fixes a device at import and
        opens the CUDA context at import, where the port's entry points
        choose the device
  H002  no counterpart (``NOT_APPLICABLE``)
  H003  no Python ``if``/``while``/``assert`` on a tensor value in
        data-plane code: ``Tensor.__bool__`` is a device-to-host sync
  H004  no inline 3e38-magnitude sentinel outside ``core/types.py``,
        in Python and in the kernels' CUDA sources (which take BIG as an
        argument)
  H005  no host materialisation in data-plane code: ``.item()``,
        ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int/float/bool`` of a
        tensor, ``np.asarray(tensor)``, ``torch.equal``, ``.to()`` onto
        the host, and the data-dependent shapes (``nonzero``,
        ``argwhere``, ``masked_select``, ``unique``, ``bincount``,
        ``repeat_interleave`` without ``output_size``, boolean-mask
        indexing); ``sanitize.fetch`` is the one sanctioned read
  H006  ``PLANE_FIELD_AXES`` matches the plane classes' tensor fields 1:1
  H007  an out-of-place tensor op used as a statement, its result dropped

"Data-plane code" is what ``callgraph`` reaches from its roots.  Taint
starts at names bound from ``torch`` calls, tensor methods and the kernel
wrappers, and at parameters annotated ``torch.Tensor``; ``.shape``,
``.dtype``, ``.device``, ``.ndim`` and ``numel()`` give host values.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import Finding, Project, SourceFile, dotted_name, scope_map

#: The JAX package's rules that have no counterpart here, with the reason.
NOT_APPLICABLE = {
    "H002": "jit/shard_map static arguments: the port compiles nothing "
            "(no jit, no torch.compile), so there is no static-argument "
            "surface to audit",
    "H006/registration": "pytree registration: PyTorch has no pytree "
                         "registry the port relies on; H006 keeps only "
                         "the PLANE_FIELD_AXES parity",
}

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

_NP_MODULES = ("numpy",)

#: ``torch.<name>`` calls (and ``torch.<sub>...`` namespaces) whose result
#: is a host value or a host object, never a tensor on a device.
_TORCH_HOST = {
    "device", "dtype", "finfo", "iinfo", "Size", "is_tensor", "numel",
    "is_floating_point", "is_complex", "get_default_dtype",
    "promote_types", "result_type", "can_cast", "no_grad",
    "inference_mode", "enable_grad", "set_grad_enabled",
    "is_grad_enabled", "Generator", "get_num_threads", "set_num_threads",
    "manual_seed", "from_numpy", "cuda", "backends", "distributed",
    "utils", "profiler", "testing", "library", "autograd", "Tensor",
    "is_storage", "typename", "get_device",
}

#: Attribute reads that are host values even on a device tensor.
_SAFE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta",
               "is_cpu", "layout", "requires_grad", "is_leaf", "names",
               "itemsize", "nbytes", "is_sparse", "is_quantized",
               "grad_fn", "type"}

#: Tensor methods whose result is a host value.
_HOST_METHODS = {"numel", "dim", "size", "stride", "element_size",
                 "data_ptr", "is_contiguous", "nelement", "get_device",
                 "is_floating_point", "is_complex", "storage_offset",
                 "ndimension", "is_pinned", "untyped_storage",
                 "item", "tolist", "cpu", "numpy", "equal"}

#: Methods whose result is on a device whatever the receiver.
_DEVICE_METHODS = {"to", "cuda", "pin_memory"}

#: The kernel wrappers: their results are device tensors.
_KERNEL_WRAPPERS = {"fused_scan_select", "hntl_scan_single", "hntl_scan",
                    "scan_single", "scan_batched", "aos_scan",
                    "pointer_chase_scan"}

#: The sanctioned host reads of ``analysis.sanitize``: host results, never
#: flagged.
_SANCTIONED_READS = {"fetch", "fetch_async"}

#: Builtins whose result is a host value regardless of argument taint.
_SHIELD_CALLS = {"len", "isinstance", "issubclass", "hasattr", "type", "id",
                 "callable", "repr", "str", "format", "range", "enumerate",
                 "zip", "abs", "tuple", "list", "dict", "set", "getattr",
                 "print"}

#: Builtins that compare or truth-test their tensor arguments in Python.
_PY_REDUCERS = {"min", "max", "sorted", "any", "all", "sum"}

#: float()/int()/bool() of a tensor: a device-to-host read.
_CONCRETIZERS = {"float", "int", "bool", "complex"}

_HOST_SINKS = {"asarray", "array", "ascontiguousarray"}

#: Calls and methods whose output shape depends on the data.
_DATA_SHAPED = {"nonzero", "argwhere", "masked_select", "unique",
                "unique_consecutive", "bincount"}

#: Calls and methods that return a boolean tensor (for mask indexing).
_BOOL_CALLS = {"logical_and", "logical_or", "logical_not", "logical_xor",
               "isin", "isnan", "isinf", "isfinite", "isneginf",
               "isposinf", "isclose", "signbit", "eq", "ne", "lt", "le",
               "gt", "ge", "greater", "less", "bool"}

_BOOL_COMPARE = (ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE)


def _module_aliases(sf: SourceFile, targets: Sequence[str]) -> Set[str]:
    """Local names bound to any of the target modules (import aliases)."""
    out: Set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in targets:
                    out.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if f"{node.module}.{a.name}" in targets:
                    out.add(a.asname or a.name)
    return out


def _torch_aliases(sf: SourceFile) -> Dict[str, str]:
    """Local name -> the ``torch`` module path it is bound to (``torch``,
    ``F`` -> ``torch.nn.functional``, ``cuda`` -> ``torch.cuda``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    if a.asname:
                        out[a.asname] = a.name
                    else:
                        out["torch"] = "torch"
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module and (node.module == "torch"
                                 or node.module.startswith("torch.")):
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _torch_path(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """The full ``torch.`` path of a Name/Attribute chain, or None."""
    dn = dotted_name(node)
    if dn is None:
        return None
    head, _, rest = dn.partition(".")
    if head not in aliases:
        return None
    return aliases[head] + ("." + rest if rest else "")


def _torch_makes_tensor(path: str) -> bool:
    """True for a ``torch.*`` call whose result is a tensor."""
    parts = path.split(".")
    return len(parts) >= 2 and parts[1] not in _TORCH_HOST


def _is_cpu_expr(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and node.args and \
            (dotted_name(node.func) or "").endswith("device"):
        return _is_cpu_expr(node.args[0])
    return False


def _is_cuda_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cuda"
    if isinstance(node, ast.Call) and node.args and \
            (dotted_name(node.func) or "").endswith("device"):
        return _is_cuda_expr(node.args[0])
    return False


def _to_host(call: ast.Call) -> bool:
    """``t.to("cpu")`` / ``t.to(torch.device("cpu"))`` / ``t.to(device=
    "cpu")``."""
    args = list(call.args) + [k.value for k in call.keywords
                              if k.arg == "device"]
    return any(_is_cpu_expr(a) for a in args)


def _callee(node: ast.Call) -> Optional[str]:
    """The last name of a call's function chain (``f`` of ``a.b.f()``)."""
    dn = dotted_name(node.func)
    if dn is not None:
        return dn.split(".")[-1]
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


# ---------------------------------------------------------------------------
# H001 — tensors made at module scope
# ---------------------------------------------------------------------------

def _makes_tensor_at_import(node: ast.AST, aliases: Dict[str, str]) -> bool:
    if not isinstance(node, ast.Call):
        return False
    path = _torch_path(node.func, aliases)
    if path is not None and (_torch_makes_tensor(path)
                             or path == "torch.from_numpy"):
        return True
    if isinstance(node.func, ast.Attribute):
        if node.func.attr == "cuda":
            return True
        if node.func.attr == "to" and any(
                _is_cuda_expr(a) for a in list(node.args)
                + [k.value for k in node.keywords if k.arg == "device"]):
            return True
    return False


def rule_h001(project: Project) -> List[Finding]:
    """A module-level tensor (``torch.tensor``, ``zeros``, ``arange``,
    ``from_numpy``, ... or anything ``.cuda()`` / ``.to("cuda")``) fixes
    its device at import, and on the card opens the CUDA context at
    import: the port's entry points choose the device.  Keep module
    constants plain Python (``types.BIG``) and build tensors inside
    functions."""
    out: List[Finding] = []
    for sf in project.files:
        aliases = _torch_aliases(sf)
        for stmt in sf.tree.body:
            if isinstance(stmt, ast.Assign):
                value, targets = stmt.value, stmt.targets
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                value, targets = stmt.value, [stmt.target]
            else:
                continue
            call = next((n for n in ast.walk(value)
                         if _makes_tensor_at_import(n, aliases)), None)
            if call is None:
                continue
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            label = ", ".join(names) or "<target>"
            out.append(Finding(
                "H001", sf.path, value.lineno, value.col_offset,
                f"module-level tensor {label!r} (made at import: fixes "
                f"its device and opens the CUDA context at import; use a "
                f"plain Python value or build it inside the function)",
                key=f"module-const:{label}"))
    return out


# ---------------------------------------------------------------------------
# H003 / H005 / H007 — taint pass over each function
# ---------------------------------------------------------------------------

_OUT_OF_PLACE_TWINS = {
    "index_put", "masked_fill", "masked_scatter", "scatter", "scatter_add",
    "scatter_reduce", "index_copy", "index_add", "index_fill",
    "index_reduce", "clamp", "clamp_min", "clamp_max", "clip",
    "nan_to_num", "addcmul", "addcdiv", "lerp", "fill_diagonal",
}
_OUT_OF_PLACE_ON_TENSORS = {
    "to", "cpu", "cuda", "float", "double", "half", "bfloat16", "long",
    "int", "short", "bool", "byte", "contiguous", "detach", "clone", "add",
    "sub", "mul", "div", "neg", "abs", "sqrt", "exp", "log", "pow",
    "square", "relu", "sigmoid", "tanh", "floor", "ceil", "round",
    "reshape", "view", "squeeze", "unsqueeze", "transpose", "permute",
    "sort", "flatten", "expand", "where", "fill", "zero", "copy",
}


class _TaintChecker:
    """One function body: track device-tensor names, flag H003/H005 (in
    data-plane functions) and H007 (everywhere)."""

    def __init__(self, sf: SourceFile, func: ast.AST, qualname: str,
                 torch_aliases: Dict[str, str], np_aliases: Set[str],
                 reachable: bool):
        self.sf = sf
        self.func = func
        self.qualname = qualname
        self.torch = torch_aliases
        self.np = np_aliases
        self.reachable = reachable
        self.env: Set[str] = set()
        self.bools: Set[str] = set()
        self.findings: List[Finding] = []

    # -- taint of an expression ------------------------------------------
    def tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.env
        if isinstance(node, ast.Attribute):
            if node.attr in _SAFE_ATTRS:
                return False
            return self.tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value)
        if isinstance(node, ast.Call):
            name = _callee(node)
            if isinstance(node.func, ast.Name):
                if node.func.id in _SHIELD_CALLS | _CONCRETIZERS \
                        | _PY_REDUCERS:
                    return False
            if name in _SANCTIONED_READS:
                return False
            path = _torch_path(node.func, self.torch)
            if path is not None:
                return _torch_makes_tensor(path)
            root = (dotted_name(node.func) or "").split(".")[0]
            if root in self.np:
                return False           # host value (H005's problem)
            if name in _KERNEL_WRAPPERS:
                return True
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _HOST_METHODS:
                    return False
                if node.func.attr in _DEVICE_METHODS:
                    return not _to_host(node)
                if self.tainted(node.func.value):
                    return True
            return any(self.tainted(a) for a in node.args) or \
                any(self.tainted(k.value) for k in node.keywords)
        if isinstance(node, ast.Compare):
            ops_safe = all(isinstance(o, (ast.Is, ast.IsNot, ast.In,
                                          ast.NotIn))
                           for o in node.ops)
            if ops_safe:
                return False
            return self.tainted(node.left) or \
                any(self.tainted(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.tainted(v) for v in node.values)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value)
        return False

    def is_bool(self, node: ast.AST) -> bool:
        """True for a device tensor of booleans (a mask)."""
        if isinstance(node, ast.Name):
            return node.id in self.bools
        if isinstance(node, ast.Compare):
            return all(isinstance(o, _BOOL_COMPARE) for o in node.ops) and \
                self.tainted(node)
        if isinstance(node, ast.UnaryOp) and \
                isinstance(node.op, (ast.Invert, ast.Not)):
            return self.is_bool(node.operand)
        if isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_bool(node.left) or self.is_bool(node.right)
        if isinstance(node, ast.Call) and self.tainted(node):
            name = _callee(node)
            if name in _BOOL_CALLS:
                return True
            if name == "to" and any(
                    (dotted_name(a) or "").endswith(".bool")
                    for a in list(node.args)
                    + [k.value for k in node.keywords]):
                return True
            return any(k.arg == "dtype"
                       and (dotted_name(k.value) or "").endswith(".bool")
                       for k in node.keywords)
        return False

    # -- entry ------------------------------------------------------------
    def run(self) -> List[Finding]:
        args = self.func.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)
                  + [x for x in (args.vararg, args.kwarg) if x]):
            ann = ast.unparse(a.annotation) if a.annotation else ""
            if "Tensor" in ann:
                self.env.add(a.arg)
        # two passes: loop-carried taint settles on the second
        for _ in range(2):
            self.visit_block(self.func.body)
        return self.findings

    # -- statements --------------------------------------------------------
    def visit_block(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            self.visit_stmt(stmt)

    def _bind(self, target: ast.AST, tainted: bool, is_bool: bool = False,
              value: Optional[ast.AST] = None) -> None:
        if isinstance(target, ast.Name):
            for env, on in ((self.env, tainted), (self.bools, is_bool)):
                if on:
                    env.add(target.id)
                else:
                    env.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)
        elif isinstance(target, ast.Subscript) and not (
                isinstance(value, ast.Constant)
                or isinstance(value, ast.UnaryOp)
                and isinstance(value.operand, ast.Constant)):
            # ``t[mask] = <number>`` is a masked_fill: no sync
            self.check_mask_index(target)

    def _scan_calls(self, node: Optional[ast.AST]) -> None:
        """H005-check every Call and Subscript under ``node``, not
        descending into nested defs (they are their own entries)."""
        if node is None or not self.reachable:
            return
        stack = [node]
        while stack:
            cur = stack.pop()
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(cur, ast.Call):
                self.check_h005(cur)
            elif isinstance(cur, ast.Subscript) and \
                    isinstance(cur.ctx, ast.Load):
                self.check_mask_index(cur)
            stack.extend(ast.iter_child_nodes(cur))

    def visit_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs are their own entries
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_calls(stmt.test)
        elif isinstance(stmt, ast.For):
            self._scan_calls(stmt.iter)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self._scan_calls(item.context_expr)
        elif not isinstance(stmt, ast.Try):
            self._scan_calls(stmt)
        if isinstance(stmt, ast.Assign):
            t, b = self.tainted(stmt.value), self.is_bool(stmt.value)
            for target in stmt.targets:
                self._bind(target, t, b, stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._bind(stmt.target, self.tainted(stmt.value),
                       self.is_bool(stmt.value), stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Subscript):
                self._bind(stmt.target, False, value=stmt.value)
            elif self.tainted(stmt.value):
                self._bind(stmt.target, True,
                           self.is_bool(stmt.target)
                           and self.is_bool(stmt.value))
        elif isinstance(stmt, (ast.If, ast.While)):
            kind = "if" if isinstance(stmt, ast.If) else "while"
            self.check_h003(stmt.test, kind)
            self.visit_block(stmt.body)
            self.visit_block(stmt.orelse)
        elif isinstance(stmt, ast.Assert):
            self.check_h003(stmt.test, "assert")
        elif isinstance(stmt, ast.For):
            if self.tainted(stmt.iter):
                self._bind(stmt.target, True)
            self.visit_block(stmt.body)
            self.visit_block(stmt.orelse)
        elif isinstance(stmt, ast.With):
            self.visit_block(stmt.body)
        elif isinstance(stmt, ast.Try):
            self.visit_block(stmt.body)
            for h in stmt.handlers:
                self.visit_block(h.body)
            self.visit_block(stmt.orelse)
            self.visit_block(stmt.finalbody)
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            self.check_h007(stmt)

    # -- findings ----------------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, message: str,
              what: str) -> None:
        key = f"{rule.lower()}:{self.qualname}:{what}"
        if any(f.key == key and f.line == node.lineno
               for f in self.findings):
            return
        self.findings.append(Finding(
            rule, self.sf.path, node.lineno, node.col_offset, message, key))

    def check_h003(self, test: ast.expr, kind: str) -> None:
        if self.reachable and self.tainted(test):
            self._emit(
                "H003", test,
                f"python `{kind}` on a tensor value in data-plane "
                f"`{self.qualname}` (Tensor.__bool__ is a device-to-host "
                f"sync on the card; use torch.where or a host value)",
                f"{kind}:{ast.unparse(test)[:60]}")

    def _h005(self, node: ast.AST, what: str, message: str) -> None:
        self._emit("H005", node,
                   f"{message} in data-plane `{self.qualname}` (a "
                   f"device-to-host sync on the card; keep the value on "
                   f"the device or read it through sanitize.fetch)", what)

    def check_h005(self, call: ast.Call) -> None:
        name = _callee(call)
        fn = dotted_name(call.func)
        root = (fn or "").split(".")[0]
        recv = call.func.value if isinstance(call.func, ast.Attribute) \
            else None
        recv_t = recv is not None and self.tainted(recv)
        path = _torch_path(call.func, self.torch)
        if name in _SANCTIONED_READS:
            return
        if root in self.np and name in _HOST_SINKS and \
                any(self.tainted(a) for a in call.args):
            self._h005(call, f"np:{name}", f"host materialisation `{fn}`")
        elif recv is not None and name in ("item", "cpu") and \
                not call.args:
            self._h005(call, name, f"`.{name}()`")
        elif recv_t and name in ("tolist", "numpy"):
            self._h005(call, name, f"`.{name}()` of a tensor")
        elif recv_t and name == "to" and _to_host(call):
            self._h005(call, "to-host", "`.to()` onto the host")
        elif isinstance(call.func, ast.Name) and \
                call.func.id in _CONCRETIZERS and call.args and \
                self.tainted(call.args[0]):
            self._h005(call, f"concretize:{call.func.id}",
                       f"`{call.func.id}()` of a tensor")
        elif isinstance(call.func, ast.Name) and \
                call.func.id in _PY_REDUCERS and \
                any(self.tainted(a) for a in call.args):
            self._h005(call, f"py-reduce:{call.func.id}",
                       f"python `{call.func.id}()` over tensors")
        elif path == "torch.equal" or (recv_t and name == "equal"):
            self._h005(call, "equal", "`torch.equal`")
        elif name in _DATA_SHAPED and (
                (path is not None and path.split(".")[-1] == name)
                or recv_t):
            self._h005(call, f"shape:{name}",
                       f"data-dependent shape `{name}`")
        elif path == "torch.where" and len(call.args) == 1 and \
                not call.keywords:
            self._h005(call, "shape:where", "data-dependent shape "
                       "`torch.where(cond)`")
        elif name == "repeat_interleave" and \
                not any(k.arg == "output_size" for k in call.keywords):
            reps = call.args[1] if path is not None and len(call.args) > 1 \
                else (call.args[0] if recv is not None and call.args
                      else None)
            if reps is not None and self.tainted(reps):
                self._h005(call, "shape:repeat_interleave",
                           "data-dependent shape `repeat_interleave` "
                           "without output_size")

    def check_mask_index(self, sub: ast.Subscript) -> None:
        if not self.reachable:
            return
        idx = sub.slice
        parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        if any(self.is_bool(p) for p in parts):
            self._emit(
                "H005", sub,
                f"boolean-mask indexing in data-plane `{self.qualname}` "
                f"(a data-dependent shape: a device-to-host sync on the "
                f"card; use torch.where or a fixed-shape gather)",
                f"shape:mask-index:{ast.unparse(idx)[:40]}")

    def check_h007(self, stmt: ast.Expr) -> None:
        call = stmt.value
        f = call.func
        if not isinstance(f, ast.Attribute):
            return
        if f.attr in _OUT_OF_PLACE_TWINS or (
                f.attr in _OUT_OF_PLACE_ON_TENSORS and self.tainted(f.value)):
            self._emit(
                "H007", stmt,
                f"`.{f.attr}(...)` result discarded (an out-of-place "
                f"tensor op returns a new tensor; bind it, or use the "
                f"in-place `.{f.attr}_`)",
                f"discard:{f.attr}")


def rule_h003_h005(project: Project) -> List[Finding]:
    """Walk every function with the taint checker: H003 (python control
    flow on tensors) and H005 (host materialisation) in the data-plane
    functions (see callgraph), H007 (discarded out-of-place ops) in all.
    A listed entry point that no longer resolves is an H003 finding."""
    out: List[Finding] = []
    graph = project.callgraph
    aliases: Dict[str, tuple] = {}
    for fi in graph.funcs:
        sf = project.by_path[fi.path]
        if fi.path not in aliases:
            aliases[fi.path] = (_torch_aliases(sf),
                                _module_aliases(sf, _NP_MODULES))
        out.extend(_TaintChecker(sf, fi.node, fi.qualname,
                                 *aliases[fi.path], fi.reachable).run())
    for dotted in graph.unresolved_roots:
        out.append(Finding(
            "H003", graph.entry_file, 1, 0,
            f"data-plane entry point {dotted!r} no longer resolves "
            f"(renamed or moved? update callgraph.ENTRY_POINTS)",
            key=f"unresolved-root:{dotted}"))
    return out


def rule_h007_module(project: Project) -> List[Finding]:
    """H007 on module-level statements (functions are walked by the taint
    pass): only the out-of-place twins, which no builtin type has."""
    out: List[Finding] = []
    for sf in project.files:
        for stmt in _module_level_stmts(sf.tree.body):
            if not (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Call)
                    and isinstance(stmt.value.func, ast.Attribute)
                    and stmt.value.func.attr in _OUT_OF_PLACE_TWINS):
                continue
            attr = stmt.value.func.attr
            out.append(Finding(
                "H007", sf.path, stmt.lineno, stmt.col_offset,
                f"`.{attr}(...)` result discarded (an out-of-place tensor "
                f"op returns a new tensor; bind it, or use `.{attr}_`)",
                key=f"h007:<module>:discard:{attr}"))
    return out


def _module_level_stmts(body: Sequence[ast.stmt]):
    """Module-level statements, through if/for/while/with/try blocks."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield stmt
        for field in ("body", "orelse", "finalbody"):
            yield from _module_level_stmts(getattr(stmt, field, ()) or ())
        for h in getattr(stmt, "handlers", ()) or ():
            yield from _module_level_stmts(h.body)


# ---------------------------------------------------------------------------
# H004 — inline 3e38-magnitude sentinel literals
# ---------------------------------------------------------------------------

#: A float literal of magnitude 1e37 .. 1e39 in C++ source: mantissa, an
#: exponent of 37 or 38 (or 36..38 with a mantissa above 10), suffix.
_CU_FLOAT = re.compile(
    r"(?<![\w.])(\d+(?:\.\d*)?|\.\d+)[eE]\+?(\d+)[fFlL]?(?![\w.])")


def _cu_sentinels(source: str):
    """(line, col, text) of every 1e37..1e39 literal outside comments."""
    text = re.sub(r"/\*.*?\*/", lambda m: re.sub(r"[^\n]", " ", m.group()),
                  source, flags=re.S)
    for n, line in enumerate(text.splitlines(), start=1):
        code = line.split("//", 1)[0]
        for m in _CU_FLOAT.finditer(code):
            value = float(m.group(1) + "e" + m.group(2))
            if 1e37 <= value < 1e39:  # hntlint: ok H004
                yield n, m.start(), m.group()


def rule_h004(project: Project) -> List[Finding]:
    """The pruned-slot sentinel is single-sourced as ``core.types.BIG``;
    an inline ``3e38``-magnitude literal is a drifting copy.  The CUDA
    kernels take BIG as an argument, so their sources are held to the
    same rule (``// hntlint: ok H004`` suppresses a line there)."""
    out: List[Finding] = []
    for sf in project.files:
        if sf.path.endswith("core/types.py"):
            continue
        scopes = scope_map(sf.tree)
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, float)):
                continue
            if not 1e37 <= abs(node.value) < 1e39:  # hntlint: ok H004
                continue
            scope = scopes.get(id(node), "<module>")
            out.append(Finding(
                "H004", sf.path, node.lineno, node.col_offset,
                f"inline sentinel literal {node.value!r} "
                f"(import core.types.BIG — inline copies drift)",
                key=f"sentinel:{scope}:{node.value!r}"))
    for tf in project.texts:
        for line, col, lit in _cu_sentinels(tf.source):
            out.append(Finding(
                "H004", tf.path, line, col,
                f"inline sentinel literal {lit} in a kernel source (the "
                f"kernels take BIG as an argument from core.types)",
                key=f"sentinel:cu:{lit}"))
    return out


# ---------------------------------------------------------------------------
# H006 — PLANE_FIELD_AXES parity with the plane classes
# ---------------------------------------------------------------------------

#: The two search-plane classes whose tensor fields the axes dict covers.
_PLANE_ROOTS = ("StackedSegments", "ShardedStackedSegments")
_AXES_NAME = "PLANE_FIELD_AXES"


def _class_fields(sf: SourceFile):
    """(fields, lines) of the module-level classes of one file."""
    fields: Dict[str, List[Tuple[str, str, int]]] = {}
    lines: Dict[str, int] = {}
    for node in sf.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        lines[node.name] = node.lineno
        fields[node.name] = [
            (stmt.target.id, ast.unparse(stmt.annotation), stmt.lineno)
            for stmt in node.body
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)]
    return fields, lines


def _axes_dict(sf: SourceFile):
    """The PLANE_FIELD_AXES dict literal, if this file assigns one."""
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if _AXES_NAME in names:
                return node.value
    return None


def rule_h006(project: Project) -> List[Finding]:
    """``PLANE_FIELD_AXES`` and the plane classes' tensor fields (those of
    ``StackedSegments`` and ``ShardedStackedSegments`` and of the classes
    they hold) match 1:1: a new field without a sharding rule, or a rule
    for a field that is gone, is a finding.  A file that defines the dict
    but neither class falls back to every class with a tensor field."""
    out: List[Finding] = []
    for sf in project.files:
        axes = _axes_dict(sf)
        if axes is None:
            continue
        fields, _ = _class_fields(sf)

        def is_tensor(ann: str) -> bool:
            return "Tensor" in ann

        roots = [r for r in _PLANE_ROOTS if r in fields] or \
            [c for c in sorted(fields)
             if any(is_tensor(a) for _, a, _ in fields[c])]
        leaves: Dict[str, Tuple[str, int]] = {}
        seen: Set[str] = set()

        def close(cls: str) -> None:
            if cls in seen or cls not in fields:
                return
            seen.add(cls)
            for fname, ann, lineno in fields[cls]:
                nested = [c for c in fields
                          if c != cls and re.search(rf"\b{c}\b", ann)]
                if nested:
                    for c in nested:
                        close(c)
                elif is_tensor(ann):
                    leaves.setdefault(fname, (cls, lineno))

        for r in roots:
            close(r)

        keys: Dict[str, int] = {}
        for k in axes.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys[k.value] = k.lineno
        for k, lineno in sorted(keys.items()):
            if k not in leaves:
                out.append(Finding(
                    "H006", sf.path, lineno, 0,
                    f"{_AXES_NAME} key {k!r} has no matching tensor field "
                    f"on the plane classes ({'/'.join(roots)})",
                    key=f"axes-key:{k}"))
        for fname, (cls, lineno) in sorted(leaves.items()):
            if fname not in keys:
                out.append(Finding(
                    "H006", sf.path, lineno, 0,
                    f"plane field {cls}.{fname} has no {_AXES_NAME} entry "
                    f"(a new field without a sharding rule)",
                    key=f"plane-leaf:{cls}.{fname}"))
    return out


ALL_RULES = (rule_h001, rule_h003_h005, rule_h004, rule_h006,
             rule_h007_module)
