"""HL001/HL005: implicit host syncs in hot regions, for torch tensors.

Statement-order taint tracking over each hot function.  A tainted value
lives on the device.  In host modules (``serving/``) taint enters
through torch calls on tainted values and torch factories given a
device, ``.to(<device>)`` of a host tensor, calls into the model and
kernel code, calls of functions whose returns are tainted (the engine's
``_decode``, the captured graphs' ``window`` and ``run``), the objects a
captured-graph class builds, and the class's ``_DEVICE_STATE``
attributes; in traced modules (``models/``, ``kernels/``) every
array-ish parameter is tainted.  Host values stay untainted: the
results of ``.cpu()``, ``.numpy()``, ``.tolist()``, ``.item()`` and
``torch.from_numpy``, tensors made without a device or pinned, and
``.shape``/``.dtype``/``.device``/``.ndim``/``.numel()`` and kin.

Sync triggers on tainted values: ``int()``/``float()``/``bool()``,
``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``.to(<cpu>)``, a
``copy_`` of one into a host tensor without ``non_blocking=True``, any
``numpy.*`` call, the ops whose output shape depends on the data
(``nonzero``, ``masked_select``, boolean-mask indexing, ``unique``,
``repeat_interleave`` by a tensor without ``output_size``), and (host
side only) iteration or branching; ``torch.cuda.synchronize`` and any
``.synchronize()`` (a stream's, an event's) always.  A trigger under a
``# hotlint: sync(reason)`` comment is intentional, but unless the
reason starts with ``uncounted:`` it must sit within two statements of a
``host_syncs`` increment, else HL005.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.hotlint import Finding, FuncInfo, Project, _flatten

_UNTAINT_ATTRS = ("shape", "dtype", "ndim", "device", "is_cuda", "layout",
                  "nbytes", "itemsize", "requires_grad")
#: tensor methods whose results are host values without a sync
_UNTAINT_METHODS = ("size", "dim", "numel", "nelement", "data_ptr", "stride",
                    "element_size", "is_contiguous", "get_device",
                    "storage_offset", "is_pinned", "query")
#: tensor methods that read a value back to the host (trigger, untaint)
_READBACK_METHODS = ("item", "tolist", "cpu", "numpy")
_SKIP_PARAMS = {"self", "cls", "cfg", "rules"}
_PROPAGATING_BUILTINS = {
    "list", "tuple", "sorted", "min", "max", "sum", "any", "all", "zip",
    "enumerate", "range", "abs", "map", "filter", "dict", "set", "reversed",
}
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "rand", "randn",
              "randint", "tensor", "as_tensor", "linspace", "eye",
              "empty_strided", "randperm", "normal"}
_LIKE_FACTORIES = {"zeros_like", "ones_like", "empty_like", "full_like",
                   "rand_like", "randn_like", "randint_like"}
_SHAPE_OPS = ("nonzero", "masked_select", "argwhere", "unique",
              "unique_consecutive")
_MASK_OPS = ("isfinite", "isnan", "isinf", "isneginf", "isposinf",
             "logical_and", "logical_or", "logical_not", "logical_xor", "eq",
             "ne", "gt", "ge", "lt", "le", "bool")
_TORCH_DTYPES = {"bool", "int8", "uint8", "int16", "int32", "int64", "long",
                 "int", "float16", "half", "bfloat16", "float32", "float",
                 "float64", "double"}


def check(project: Project) -> List[Finding]:
    return _analyze(project)[0]


def suppressed_sites(project: Project) -> List[Tuple[str, str, bool]]:
    return _analyze(project)[1]


def _analyze(project: Project):
    cached = getattr(project, "_sync_cache", None)
    if cached is not None:
        return cached
    findings: List[Finding] = []
    sites: List[Tuple[str, str, bool]] = []
    for func in project.func_index.values():
        if func.hot:
            scan = _SyncScan(project, func)
            scan.run()
            findings.extend(scan.findings)
            sites.extend(scan.sites)
    project._sync_cache = (findings, sites)  # type: ignore[attr-defined]
    return findings, sites


def returns_device(project: Project, func: FuncInfo) -> bool:
    """Whether ``func`` returns a device value: a traced module's
    function always; a host function when one of its ``return``
    expressions is tainted under its own scan."""
    if func.module.kind == "traced":
        return True
    return _returns(project, func)[0]


def returns_host_tensor(project: Project, func: FuncInfo) -> bool:
    """Whether a host function returns a tensor in host memory (one it
    makes without a device, or pinned)."""
    return func.module.kind == "host" and _returns(project, func)[1]


def _returns(project: Project, func: FuncInfo) -> Tuple[bool, bool]:
    """(device, host tensor) of ``func``'s returns, memoised; a function
    under analysis counts as neither."""
    memo: Dict[str, Tuple[bool, bool]] = project.__dict__.setdefault(
        "_returns", {})
    if func.full not in memo:
        memo[func.full] = (False, False)
        scan = _SyncScan(project, func, summary=True)
        scan.run()
        memo[func.full] = (scan.returns_tainted, scan.returns_host)
    return memo[func.full]


def graph_classes(project: Project) -> Set[str]:
    """Full names of the classes that capture a CUDA graph: each builds
    ``torch.cuda.CUDAGraph`` in one of its methods, or derives from a
    class that does."""
    cached = project.__dict__.get("_graph_classes")
    if cached is not None:
        return cached
    direct = set()
    for cls in project.class_index.values():
        aliases = cls.module.aliases
        for node in ast.walk(cls.node):
            if isinstance(node, ast.Call):
                parts = _flatten(node.func)
                if parts and parts[-1] == "CUDAGraph":
                    head = aliases.get(parts[0], parts[0])
                    if head == "torch" or len(parts) == 1:
                        direct.add(cls.full)
    out = {c.full for c in project.class_index.values()
           if any(b.full in direct for b in project.mro(c))}
    project._graph_classes = out  # type: ignore[attr-defined]
    return out


class _SyncScan:
    def __init__(self, project: Project, func: FuncInfo,
                 summary: bool = False) -> None:
        self.p = project
        self.f = func
        self.mod = func.module
        self.host = self.mod.kind == "host"
        self.summary = summary
        self.returns_tainted = False
        self.returns_host = False
        #: names and self attributes known to hold host (CPU) tensors
        self.host_vals: Set[str] = set()
        self.findings: List[Finding] = []
        self.sites: List[Tuple[str, str, bool]] = []
        self._seen: Set[Tuple[str, int, str]] = set()
        self.taint: Set[str] = set()
        self.aliases = {**self.mod.aliases, **func.local_aliases}
        if func.cls:
            cls = project.func_class(func)
            for c in (project.mro(cls) if cls else []):
                for attr in c.module.device_state.get(c.name, ()):
                    self.taint.add(f"a:{attr}")
            graphs = graph_classes(project)
            for (m, c, attr), full in project.attr_types.items():
                if m == self.mod.name and c == func.cls and full in graphs:
                    self.taint.add(f"a:{attr}")
        args = func.node.args
        if self.host:
            # a parameter annotated as a tensor is a device value
            for p in args.posonlyargs + args.args + args.kwonlyargs:
                if _tensor_annotation(p.annotation):
                    self.taint.add(f"n:{p.arg}")
        else:
            const_default_kwonly = {
                p.arg for p, d in zip(args.kwonlyargs, args.kw_defaults)
                if d is not None and isinstance(d, ast.Constant)}
            # params annotated as plain python scalars (shape ints, flags)
            # are static-like, not device tensors
            scalar_annotated = {
                p.arg for p in args.posonlyargs + args.args + args.kwonlyargs
                if _scalar_annotation(p.annotation)
                or _config_annotation(p.annotation)}
            for name in func.params() + (
                    [args.vararg.arg] if args.vararg else []):
                if name not in _SKIP_PARAMS \
                        and name not in const_default_kwonly \
                        and name not in scalar_annotated:
                    self.taint.add(f"n:{name}")

    def run(self) -> None:
        self.walk_body(self.f.node.body)

    # -- taint --------------------------------------------------------------

    def tainted(self, e) -> bool:
        if isinstance(e, ast.Name):
            return f"n:{e.id}" in self.taint
        if isinstance(e, ast.Attribute):
            if e.attr in _UNTAINT_ATTRS:
                return False
            if isinstance(e.value, ast.Name) and e.value.id == "self":
                return f"a:{e.attr}" in self.taint
            return self.tainted(e.value)
        if isinstance(e, ast.Subscript):
            return self.tainted(e.value)
        if isinstance(e, ast.Call):
            return self.call_tainted(e)
        if isinstance(e, ast.BinOp):
            return self.tainted(e.left) or self.tainted(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.tainted(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.tainted(v) for v in e.values)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False      # identity: no value is read
            return (self.tainted(e.left)
                    or any(self.tainted(c) for c in e.comparators))
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(x) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(self.tainted(v) for v in e.values if v is not None)
        if isinstance(e, ast.IfExp):
            return self.tainted(e.body) or self.tainted(e.orelse)
        if isinstance(e, ast.Starred):
            return self.tainted(e.value)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.tainted(e.elt) or any(
                self.tainted(g.iter) for g in e.generators)
        return False

    def _args_tainted(self, call: ast.Call) -> bool:
        return (any(self.tainted(a) for a in call.args)
                or any(self.tainted(k.value) for k in call.keywords))

    def _dotted(self, expr) -> str:
        parts = _flatten(expr)
        if not parts:
            return ""
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def call_tainted(self, call: ast.Call) -> bool:
        fn = call.func
        dotted = self._dotted(fn)
        root = dotted.split(".")[0] if dotted else ""
        if root == "torch":
            return self._torch_tainted(dotted, call)
        if root == "numpy":
            return False          # host result; the trigger is flagged
        if isinstance(fn, ast.Name):
            n = fn.id
            if n in ("int", "float", "bool", "len", "str", "repr",
                     "isinstance", "hasattr", "getattr", "id", "type"):
                return False
            if n in _PROPAGATING_BUILTINS:
                return self._args_tainted(call)
        if isinstance(fn, ast.Attribute):
            if fn.attr in _READBACK_METHODS or fn.attr in _UNTAINT_METHODS:
                return False      # host result; trigger flagged separately
            if fn.attr == "to":
                return self._to_tainted(call)
            if self.tainted(fn.value):
                return True       # method on a device value
        rc = self.p.resolve_call(self.f, call)
        if rc.builds is not None:
            return rc.builds.full in graph_classes(self.p)
        if rc.targets:
            if any(t.module.kind == "traced" for t in rc.targets):
                return True       # model/kernel code returns device tensors
            if isinstance(fn, ast.Attribute):
                owner = self.p.object_class(self.f, fn.value)
                if owner is not None and owner.full in graph_classes(self.p):
                    return True   # a captured graph's buffers
            if len(rc.targets) == 1 and returns_device(self.p, rc.targets[0]):
                return True
            return self._args_tainted(call)
        return self._args_tainted(call)

    def _torch_tainted(self, dotted: str, call: ast.Call) -> bool:
        parts = dotted.split(".")
        name = parts[-1]
        if len(parts) > 2 or name == "from_numpy":
            return False          # torch.cuda.*, torch.backends.*, ...
        kw = {k.arg: k.value for k in call.keywords if k.arg}
        if name in _FACTORIES:
            return "device" in kw and not _is_cpu(kw["device"]) \
                and not _is_true(kw.get("pin_memory"))
        if name in _LIKE_FACTORIES:
            if "device" in kw:
                return not _is_cpu(kw["device"])
            return bool(call.args) and self.tainted(call.args[0])
        return self._args_tainted(call)

    def _to_tainted(self, call: ast.Call) -> bool:
        recv = call.func.value
        targets = list(call.args) + [k.value for k in call.keywords
                                     if k.arg == "device"]
        if any(_is_cpu(t) for t in targets):
            return False
        if self.tainted(recv):
            return True
        return any(_is_device(t) for t in targets)

    def is_host(self, e) -> bool:
        """Whether ``e`` is a tensor known to live in host memory."""
        if isinstance(e, ast.Name):
            return f"n:{e.id}" in self.host_vals
        if (isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name)
                and e.value.id == "self"):
            return f"a:{e.attr}" in self.host_vals
        if isinstance(e, ast.Subscript):
            return self.is_host(e.value)
        if not isinstance(e, ast.Call) or self.tainted(e):
            return False
        fn = e.func
        dotted = self._dotted(fn)
        kw = {k.arg: k.value for k in e.keywords if k.arg}
        if dotted == "torch.from_numpy":
            return True
        if dotted.startswith("torch.") and dotted.count(".") == 1:
            name = dotted.split(".")[1]
            if name in _FACTORIES or name in _LIKE_FACTORIES:
                return "device" not in kw or _is_cpu(kw["device"])
            return False
        if isinstance(fn, ast.Attribute):
            if fn.attr in ("cpu", "pin_memory"):
                return True
            if fn.attr == "to":
                return any(_is_cpu(t) for t in list(e.args)
                           + [k.value for k in e.keywords
                              if k.arg == "device"])
            if fn.attr in ("view", "reshape", "contiguous", "clone",
                           "flatten", "movedim", "permute", "transpose"):
                return self.is_host(fn.value)
        rc = self.p.resolve_call(self.f, e)
        return (len(rc.targets) == 1
                and returns_host_tensor(self.p, rc.targets[0]))

    # -- triggers -----------------------------------------------------------

    def check_call(self, call: ast.Call, ctx) -> None:
        fn = call.func
        if (isinstance(fn, ast.Name) and fn.id in ("int", "float", "bool")
                and self._args_tainted(call)):
            self._flag(ctx, call.lineno,
                       f"{fn.id}() forces a host sync on a device value")
            return
        dotted = self._dotted(fn)
        if dotted == "torch.cuda.synchronize":
            self._flag(ctx, call.lineno,
                       "torch.cuda.synchronize is an explicit host sync")
            return
        if isinstance(fn, ast.Attribute):
            recv_t = self.tainted(fn.value)
            if fn.attr == "synchronize":
                self._flag(ctx, call.lineno,
                           ".synchronize() is an explicit host sync")
                return
            if fn.attr in _READBACK_METHODS and recv_t:
                self._flag(ctx, call.lineno,
                           f".{fn.attr}() forces a host sync")
                return
            if fn.attr == "to" and recv_t and any(
                    _is_cpu(t) for t in list(call.args)
                    + [k.value for k in call.keywords if k.arg == "device"]):
                self._flag(ctx, call.lineno,
                           ".to(cpu) copies a device value to the host")
                return
            blocking = not any(k.arg == "non_blocking" and _is_true(k.value)
                               for k in call.keywords)
            if (fn.attr == "copy_" and blocking and call.args
                    and self.is_host(fn.value)
                    and self.tainted(call.args[0])):
                self._flag(ctx, call.lineno,
                           "copy_ of a device value into host memory waits "
                           "for it")
                return
            if (fn.attr == "copy_" and blocking and call.args and recv_t
                    and self.is_host(call.args[0])):
                self._flag(ctx, call.lineno,
                           "copy_ of a host tensor into device memory "
                           "without non_blocking=True waits for the device")
                return
            if (fn.attr == "to" and blocking and self.is_host(fn.value)
                    and any(_is_device(t) for t in list(call.args)
                            + [k.value for k in call.keywords
                               if k.arg == "device"])):
                self._flag(ctx, call.lineno,
                           ".to(<device>) of a host tensor without "
                           "non_blocking=True waits for the device")
                return
            if fn.attr in _SHAPE_OPS and (recv_t or self._args_tainted(call)):
                self._flag(ctx, call.lineno,
                           f"{fn.attr}() has a data-dependent shape: a host "
                           f"sync")
                return
            if fn.attr == "repeat_interleave" and self._repeats_sync(call):
                self._flag(ctx, call.lineno,
                           "repeat_interleave by a device tensor without "
                           "output_size is a host sync")
                return
        root = dotted.split(".")[0] if dotted else ""
        if root == "torch" and dotted.count(".") == 1:
            name = dotted.split(".")[1]
            kw = {k.arg: k.value for k in call.keywords if k.arg}
            if name in ("tensor", "as_tensor") and "device" in kw \
                    and _is_device(kw["device"]) and call.args \
                    and not self.tainted(call.args[0]):
                self._flag(ctx, call.lineno,
                           f"torch.{name}(..., device=) copies host data "
                           f"with a blocking host-to-device copy")
            elif name == "where" and len(call.args) == 1 \
                    and self._args_tainted(call):
                self._flag(ctx, call.lineno,
                           "where(cond) has a data-dependent shape: a host "
                           "sync")
        elif root == "numpy" and self._args_tainted(call):
            self._flag(ctx, call.lineno,
                       f"{dotted.split('.', 1)[1]}() copies a device value "
                       f"to host")

    def _repeats_sync(self, call: ast.Call) -> bool:
        if any(k.arg == "output_size" for k in call.keywords):
            return False
        fn = call.func
        dotted = self._dotted(fn)
        args = list(call.args)
        if dotted == "torch.repeat_interleave":
            args = args[1:]
        elif not self.tainted(fn.value):
            return False
        rep = args[0] if args else next(
            (k.value for k in call.keywords if k.arg == "repeats"), None)
        return rep is not None and self.tainted(rep)

    def check_subscript(self, node: ast.Subscript, ctx) -> None:
        if not self.tainted(node.value):
            return
        sl = node.slice
        elts = list(sl.elts) if isinstance(sl, ast.Tuple) else [sl]
        if any(self._is_mask(e) for e in elts):
            self._flag(ctx, node.lineno,
                       "boolean-mask indexing has a data-dependent shape: a "
                       "host sync")

    def _is_mask(self, e) -> bool:
        if isinstance(e, ast.Name):
            return f"m:{e.id}" in self.taint
        if isinstance(e, ast.Compare):
            return self.tainted(e)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self._is_mask(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_mask(e.left) or self._is_mask(e.right)
        if isinstance(e, ast.Call) and self.tainted(e):
            fn = e.func
            if isinstance(fn, ast.Attribute):
                if fn.attr in _MASK_OPS:
                    return True
                if fn.attr == "to" and any(
                        _dtype_name(a) == "bool" for a in e.args):
                    return True
        return False

    # -- statement walk -----------------------------------------------------

    def walk_body(self, body: List[ast.stmt]) -> None:
        for i, stmt in enumerate(body):
            self.visit(stmt, body, i)

    def visit(self, stmt: ast.stmt, body, i) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        ctx = (body, i, stmt)
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            if self.tainted(stmt.value):
                self.returns_tainted = True
            elif self.is_host(stmt.value):
                self.returns_host = True
        for expr in _header_exprs(stmt):
            for node in ast.walk(expr):
                if isinstance(node, ast.Call):
                    self.check_call(node, ctx)
                elif isinstance(node, ast.Subscript):
                    self.check_subscript(node, ctx)
        if (self.host and isinstance(stmt, (ast.If, ast.While))
                and self.tainted(stmt.test)):
            self._flag(ctx, stmt.lineno, "branching on a device value")
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if (isinstance(t, ast.Subscript) and self.tainted(t.value)
                        and not self.tainted(stmt.value)):
                    self._flag(ctx, stmt.lineno,
                               "writing a host value into a device tensor "
                               "by index is a blocking host-to-device copy: "
                               "fill_ it, or copy a device value")
        self._apply_assign(stmt)
        for sub in _sub_bodies(stmt):
            if isinstance(stmt, (ast.For, ast.While)):
                self.walk_body(sub)   # twice: catch late-taint-early-use
                self.walk_body(sub)
            else:
                self.walk_body(sub)

    def _apply_assign(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if (isinstance(t, (ast.Tuple, ast.List))
                        and isinstance(stmt.value, (ast.Tuple, ast.List))
                        and len(t.elts) == len(stmt.value.elts)):
                    for te, ve in zip(t.elts, stmt.value.elts):
                        self._assign(te, self.tainted(ve), self._is_mask(ve),
                                     self.is_host(ve))
                else:
                    self._assign(t, self.tainted(stmt.value),
                                 self._is_mask(stmt.value),
                                 self.is_host(stmt.value))
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._assign(stmt.target, self.tainted(stmt.value),
                         self._is_mask(stmt.value), self.is_host(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            vt = self.tainted(stmt.value) or self.tainted(stmt.target)
            self._assign(stmt.target, vt, False)
        elif isinstance(stmt, ast.For):
            self._assign(stmt.target, self.tainted(stmt.iter), False)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                if item.optional_vars is not None:
                    self._assign(item.optional_vars,
                                 self.tainted(item.context_expr), False)
        elif (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
              and isinstance(stmt.value.func, ast.Attribute)
              and stmt.value.func.attr in ("append", "extend", "insert")
              and isinstance(stmt.value.func.value, ast.Name)
              and self._args_tainted(stmt.value)):
            # a device value put into a local list taints the list
            self.taint.add(f"n:{stmt.value.func.value.id}")

    def _assign(self, target, vt: bool, mask: bool,
                host: bool = False) -> None:
        key = None
        if isinstance(target, ast.Name):
            key = f"n:{target.id}"
            (self.taint.add if mask else self.taint.discard)(
                f"m:{target.id}")
        elif (isinstance(target, ast.Attribute)
              and isinstance(target.value, ast.Name)
              and target.value.id == "self"):
            key = f"a:{target.attr}"
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._assign(e, vt, False)
            return
        elif isinstance(target, ast.Starred):
            self._assign(target.value, vt, False)
            return
        if key is not None:
            (self.taint.add if vt else self.taint.discard)(key)
            (self.host_vals.add if host and not vt
             else self.host_vals.discard)(key)

    # -- reporting ----------------------------------------------------------

    def _flag(self, ctx, line: int, message: str) -> None:
        if self.summary:
            return
        body, i, stmt = ctx
        sup = self.mod.suppression_for(stmt)
        if sup is not None:
            sup.used = True
            self.sites.append((self.mod.path, self.f.name, sup.counted))
            if sup.counted and not _has_increment(body, i):
                self._add("HL005", sup.line,
                          f"suppressed sync '{sup.reason.strip()}' has no "
                          f"host_syncs increment within two statements")
            return
        self._add("HL001", line, message)

    def _add(self, rule: str, line: int, message: str) -> None:
        key = (rule, line, message)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(rule, self.mod.path, line,
                                     self.f.qualname, message))


def _is_cpu(e) -> bool:
    """A constant CPU device: ``"cpu"``, ``torch.device("cpu")``."""
    if isinstance(e, ast.Constant) and isinstance(e.value, str):
        return e.value.split(":")[0] == "cpu"
    if isinstance(e, ast.Call) and _flatten(e.func)[-1:] == ["device"] \
            and e.args:
        return _is_cpu(e.args[0])
    return False


def _is_device(e) -> bool:
    """An expression that names a device (not a dtype): a ``"cuda"``
    string, a ``torch.device(...)``, or a name or attribute called
    ``device``/``dev`` (``self.device``, ``q.device``)."""
    if isinstance(e, ast.Constant) and isinstance(e.value, str):
        return e.value.split(":")[0] == "cuda"
    if isinstance(e, ast.Call):
        return _flatten(e.func)[-1:] == ["device"]
    parts = _flatten(e)
    return bool(parts) and parts[-1] in ("device", "dev")


def _dtype_name(e) -> str:
    parts = _flatten(e)
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _TORCH_DTYPES:
        return parts[1]
    return ""


def _is_true(e) -> bool:
    return isinstance(e, ast.Constant) and e.value is True


def _scalar_annotation(ann) -> bool:
    """``n: int``-style annotations (incl. ``Optional[int]`` / ``"int"``)."""
    scalars = ("int", "float", "bool", "str")
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in scalars
    if isinstance(ann, ast.Name):
        return ann.id in scalars
    if isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name) \
            and ann.value.id == "Optional":
        return _scalar_annotation(ann.slice)
    return False


def _tensor_annotation(ann) -> bool:
    """``x: torch.Tensor`` (or ``Tensor``, ``Optional[torch.Tensor]``)."""
    if isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name) \
            and ann.value.id == "Optional":
        return _tensor_annotation(ann.slice)
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in ("torch.Tensor", "Tensor")
    return _flatten(ann)[-1:] == ["Tensor"] if ann is not None else False


def _config_annotation(ann) -> bool:
    """A configuration object (``m: MoEConfig``): static, not a tensor."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.endswith("Config")
    parts = _flatten(ann) if ann is not None else []
    return bool(parts) and parts[-1].endswith("Config")


def _has_increment(body, i) -> bool:
    for stmt in body[i:i + 3]:
        for node in ast.walk(stmt):
            if isinstance(node, ast.AugAssign):
                t = node.target
                if (isinstance(t, ast.Name) and t.id == "host_syncs") or (
                        isinstance(t, ast.Attribute)
                        and t.attr == "host_syncs"):
                    return True
    return False


def _header_exprs(stmt: ast.stmt) -> List[ast.expr]:
    if isinstance(stmt, ast.Assign):
        return [stmt.value] + list(stmt.targets)
    if isinstance(stmt, ast.AnnAssign):
        return [stmt.value] if stmt.value else []
    if isinstance(stmt, ast.AugAssign):
        return [stmt.value, stmt.target]
    if isinstance(stmt, (ast.Expr, ast.Return)):
        return [stmt.value] if stmt.value else []
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, ast.For):
        return [stmt.iter]
    if isinstance(stmt, ast.With):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, ast.Assert):
        return [stmt.test] + ([stmt.msg] if stmt.msg else [])
    if isinstance(stmt, ast.Raise):
        return [e for e in (stmt.exc, stmt.cause) if e]
    if isinstance(stmt, ast.Delete):
        return list(stmt.targets)
    return []


def _sub_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
    out: List[List[ast.stmt]] = []
    for field in ("body", "orelse", "finalbody"):
        sub = getattr(stmt, field, None)
        if sub and isinstance(sub[0], ast.stmt):
            out.append(sub)
    for handler in getattr(stmt, "handlers", []):
        out.append(handler.body)
    return out
