"""hotlint: AST-based static analyzer for the port's serving hot path
(DESIGN.md §13), the reference package's ``analysis/hotlint.py`` with
its rules rewritten for torch tensors, CUDA graphs and ctypes.

Pure stdlib: parses, never imports, the code under analysis (and reads
the CUDA sources as text).  The project model below (modules, classes,
functions, import aliases, the objects held on ``self`` and in locals,
and the hot-set closure over the call graph) is shared by the rule
modules in ``repro_torch.analysis.rules``.  Each port rule answers the
reference rule of the same number:

  HL001  implicit host sync in a hot region (the reference's HL001, for
         torch tensors: readbacks, blocking copies to the host, stream
         and device synchronisation, data-dependent output shapes)
  HL002  a device tensor that a captured CUDA graph reads is rebound
         (the reference's HL002, use after donation: in both, a buffer
         the compiled program holds goes stale under the Python name)
  HL004  a ctypes ``argtypes`` list that disagrees with its ``extern
         "C"`` signature in ``csrc/*.cu`` (the reference's HL004,
         ``pallas_call`` arity against the kernel's refs)
  HL005  suppressed sync without a ``host_syncs`` increment (as the
         reference's)

The reference's HL003 (``jax.jit`` hygiene) has no counterpart: the port
compiles nothing with jit.

Hot regions are functions named ``step_window``/``prefill_wave``,
functions decorated ``@hot_path`` (the engines' loops, the model facade,
the kernel wrappers), and everything transitively reachable from them
through resolvable calls: module functions through import aliases (the
model facade ``M.decode_multi_paged``), methods through ``self`` and the
class's bases, constructors (``SpecGraph(...)`` reaches its
``__init__``), and methods of objects held on ``self`` or in a local
(``self._decode_graph.window``, ``graph.window``).  Intentional syncs
carry ``# hotlint: sync(reason)``; a reason starting with
``uncounted:`` opts out of the HL005 counter audit (used for barriers
that are not readbacks).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

HOT_SEEDS = ("step_window", "prefill_wave")
SUPPRESS_RE = re.compile(r"#\s*hotlint:\s*sync\(([^)]*)\)")
#: when a directory is linted, only these subpackages are walked
SCAN_SUBDIRS = ("serving", "models", "kernels")
#: the CUDA sources of a linted package root (read by HL004)
CSRC_SUBDIR = "csrc"


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    func: str
    message: str

    def render(self) -> str:
        return f"{self.rule} {self.path}:{self.line} ({self.func}) {self.message}"

    def baseline_key(self) -> str:
        # line-number free so the baseline survives unrelated edits
        return f"{self.rule} {self.path} {self.func} {self.message}"


@dataclasses.dataclass
class Suppression:
    line: int
    reason: str
    used: bool = False

    @property
    def counted(self) -> bool:
        return not self.reason.strip().startswith("uncounted")


class FuncInfo:
    def __init__(self, module: "ModuleInfo", qualname: str,
                 node: ast.FunctionDef, cls: Optional[str] = None) -> None:
        self.module = module
        self.qualname = qualname
        self.name = node.name
        self.node = node
        self.cls = cls
        self.hot = False
        self.hot_annotated = any(
            _dec_name(d) == "hot_path" for d in node.decorator_list)
        self.is_classmethod = any(
            _dec_name(d) == "classmethod" for d in node.decorator_list)
        self.local_aliases: Dict[str, str] = {}
        #: local name -> full class name of the object it holds
        self.local_types: Dict[str, str] = {}
        for stmt in ast.walk(node):
            if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                _collect_aliases(stmt, self.local_aliases, module.package)

    @property
    def full(self) -> str:
        return f"{self.module.name}.{self.qualname}"

    def params(self) -> List[str]:
        a = self.node.args
        return ([p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
                + [p.arg for p in a.kwonlyargs])

    def pos_params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]


def _dec_name(dec: ast.expr) -> str:
    if isinstance(dec, ast.Call):
        return _dec_name(dec.func)
    if isinstance(dec, ast.Attribute):
        return dec.attr
    if isinstance(dec, ast.Name):
        return dec.id
    return ""


def _collect_aliases(stmt, out: Dict[str, str], package: str) -> None:
    if isinstance(stmt, ast.Import):
        for al in stmt.names:
            out[al.asname or al.name.split(".")[0]] = (
                al.name if al.asname else al.name.split(".")[0])
    elif isinstance(stmt, ast.ImportFrom):
        base = stmt.module or ""
        if stmt.level:
            parts = package.split(".") if package else []
            parts = parts[:len(parts) - (stmt.level - 1)] if stmt.level > 1 \
                else parts
            base = ".".join(parts + ([stmt.module] if stmt.module else []))
        for al in stmt.names:
            if al.name == "*":
                continue
            out[al.asname or al.name] = f"{base}.{al.name}" if base else al.name


@dataclasses.dataclass
class ClassInfo:
    module: "ModuleInfo"
    name: str
    node: ast.ClassDef
    bases: List[str]              # dotted base names, as written

    @property
    def full(self) -> str:
        return f"{self.module.name}.{self.name}"


class ModuleInfo:
    def __init__(self, name: str, path: str, source: str) -> None:
        self.name = name
        self.path = path
        self.package = name.rsplit(".", 1)[0] if "." in name else ""
        self.tree = ast.parse(source, filename=path)
        norm = path.replace(os.sep, "/")
        self.kind = ("traced" if ("/models/" in norm or "/kernels/" in norm)
                     else "host")
        self.aliases: Dict[str, str] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.device_state: Dict[str, Tuple[str, ...]] = {}
        self.suppressions: List[Suppression] = []
        for i, line in enumerate(source.splitlines()):
            m = SUPPRESS_RE.search(line)
            if m:
                self.suppressions.append(Suppression(i + 1, m.group(1)))
        self._collect()

    def _collect(self) -> None:
        for node in self.tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                _collect_aliases(node, self.aliases, self.package)
            elif isinstance(node, ast.FunctionDef):
                self.functions[node.name] = FuncInfo(self, node.name, node)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = ClassInfo(
                    self, node.name, node,
                    [d for d in map(_dotted_name, node.bases) if d])
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        q = f"{node.name}.{item.name}"
                        self.functions[q] = FuncInfo(self, q, item, node.name)
                    elif isinstance(item, ast.Assign):
                        for t in item.targets:
                            if (isinstance(t, ast.Name)
                                    and t.id == "_DEVICE_STATE"
                                    and isinstance(item.value, ast.Tuple)):
                                self.device_state[node.name] = tuple(
                                    e.value for e in item.value.elts
                                    if isinstance(e, ast.Constant))

    def suppression_for(self, stmt: ast.stmt) -> Optional[Suppression]:
        # matches a comment inside the statement's span or on the line
        # directly above it (the leading-comment form)
        end = getattr(stmt, "end_lineno", stmt.lineno)
        for s in self.suppressions:
            if stmt.lineno - 1 <= s.line <= end:
                return s
        return None


def _dotted_name(expr: ast.expr) -> str:
    parts = _flatten(expr)
    return ".".join(parts)


@dataclasses.dataclass
class Resolved:
    targets: List[FuncInfo]
    #: the class a constructor call builds (its ``__init__`` is a target)
    builds: Optional[ClassInfo] = None


class Project:
    def __init__(self, modules: Dict[str, ModuleInfo],
                 cu_files: Sequence[str] = ()) -> None:
        self.modules = modules
        self.cu_files = sorted(set(cu_files))
        self.func_index: Dict[str, FuncInfo] = {}
        self.name_index: Dict[str, List[FuncInfo]] = {}
        self.class_index: Dict[str, ClassInfo] = {}
        for m in modules.values():
            for f in m.functions.values():
                self.func_index[f.full] = f
                self.name_index.setdefault(f.name, []).append(f)
            for c in m.classes.values():
                self.class_index[c.full] = c
        #: (module, class, attr) -> full class name of the object held
        self.attr_types: Dict[Tuple[str, str, str], str] = {}
        self._bind_objects()
        self._build_hot()

    # -- classes ------------------------------------------------------------

    def _aliases(self, func: FuncInfo) -> Dict[str, str]:
        return {**func.module.aliases, **func.local_aliases}

    def class_of(self, dotted: str, mod: ModuleInfo) -> Optional[ClassInfo]:
        """The project class a dotted name (as written in ``mod``) names."""
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        if head in mod.classes and not rest:
            return mod.classes[head]
        full = mod.aliases.get(head)
        if full is not None:
            full = f"{full}.{rest}" if rest else full
            return self.class_index.get(full)
        return self.class_index.get(dotted)

    def mro(self, cls: ClassInfo) -> List[ClassInfo]:
        """``cls`` and its project bases, depth first."""
        out: List[ClassInfo] = []
        work = [cls]
        while work:
            c = work.pop(0)
            if c in out:
                continue
            out.append(c)
            for b in c.bases:
                base = self.class_of(b, c.module)
                if base is not None:
                    work.append(base)
        return out

    def method(self, cls: ClassInfo, name: str) -> Optional[FuncInfo]:
        for c in self.mro(cls):
            f = c.module.functions.get(f"{c.name}.{name}")
            if f is not None:
                return f
        return None

    def func_class(self, func: FuncInfo) -> Optional[ClassInfo]:
        return func.module.classes.get(func.cls) if func.cls else None

    # -- objects held on self and in locals ---------------------------------

    def built_class(self, func: FuncInfo, expr) -> Optional[ClassInfo]:
        """The project class an expression builds: ``C(...)``, a
        classmethod ``C.make(...)`` that returns ``cls(...)``, or
        ``cls(...)`` inside a classmethod."""
        if not isinstance(expr, ast.Call):
            return None
        f = expr.func
        if isinstance(f, ast.Name) and f.id == "cls" and func.is_classmethod:
            return self.func_class(func)
        dotted = _dotted_name(f)
        c = self.class_of(dotted, func.module)
        if c is not None:
            return c
        if isinstance(f, ast.Attribute):
            owner = self.class_of(_dotted_name(f.value), func.module)
            if owner is not None:
                m = self.method(owner, f.attr)
                if m is not None and m.is_classmethod:
                    return owner
        return None

    def _bind_objects(self) -> None:
        """``self.x = C(...)`` (or ``C.make(...)``) in a method: objects
        of project classes held on ``self``; the same for locals."""
        for mod in self.modules.values():
            for func in mod.functions.values():
                for stmt in ast.walk(func.node):
                    if not isinstance(stmt, ast.Assign):
                        continue
                    pairs = []
                    for t in stmt.targets:
                        if (isinstance(t, ast.Tuple)
                                and isinstance(stmt.value, ast.Tuple)
                                and len(t.elts) == len(stmt.value.elts)):
                            pairs.extend(zip(t.elts, stmt.value.elts))
                        else:
                            pairs.append((t, stmt.value))
                    for t, v in pairs:
                        c = self.built_class(func, v)
                        if c is None:
                            continue
                        if isinstance(t, ast.Name):
                            func.local_types[t.id] = c.full
                        elif (isinstance(t, ast.Attribute)
                              and isinstance(t.value, ast.Name)
                              and t.value.id == "self" and func.cls):
                            self.attr_types[(mod.name, func.cls,
                                             t.attr)] = c.full

    def object_class(self, func: FuncInfo, expr) -> Optional[ClassInfo]:
        """The project class of the object ``expr`` (``self``, a typed
        local, or a typed attribute of ``self``) holds."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and func.cls:
                return self.func_class(func)
            full = func.local_types.get(expr.id)
            return self.class_index.get(full) if full else None
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and func.cls):
            cls = self.func_class(func)
            for c in (self.mro(cls) if cls else []):
                full = self.attr_types.get((c.module.name, c.name, expr.attr))
                if full:
                    return self.class_index.get(full)
        if (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
                and expr.func.id == "super" and func.cls):
            return self.func_class(func)
        return None

    # -- call resolution ----------------------------------------------------

    def resolve_call(self, func: FuncInfo, call: ast.Call) -> Resolved:
        aliases = self._aliases(func)
        f = call.func
        built = self.built_class(func, call)
        if built is not None and (
                isinstance(f, ast.Name)
                or self.class_of(_dotted_name(f), func.module) is not None):
            # C(...) or cls(...): the constructor (a classmethod C.make(...)
            # resolves below, to C.make)
            init = self.method(built, "__init__")
            return Resolved([init] if init else [], built)
        if isinstance(f, ast.Name):
            n = f.id
            if n in func.module.functions:
                return Resolved([func.module.functions[n]])
            dotted = aliases.get(n)
            if dotted:
                tgt = self.func_index.get(dotted)
                return Resolved([tgt] if tgt else [])
            return Resolved([])
        if isinstance(f, ast.Attribute):
            owner = self.object_class(func, f.value)
            if (isinstance(f.value, ast.Call)
                    and isinstance(f.value.func, ast.Name)
                    and f.value.func.id == "super"):
                # super().m(...): the first project base that defines m
                tgt = next(filter(None, (
                    self.method(b, f.attr)
                    for b in (self.mro(owner)[1:] if owner else []))), None)
                return Resolved([tgt] if tgt else [])
            if owner is not None:
                tgt = self.method(owner, f.attr)
                if tgt is not None:
                    return Resolved([tgt])
            parts = _flatten(f)
            if parts and parts[0] in aliases and parts[0] != "self":
                dotted = ".".join([aliases[parts[0]]] + parts[1:])
                tgt = self.func_index.get(dotted)
                return Resolved([tgt] if tgt else [])
            if parts and parts[0] in func.module.classes:
                tgt = self.func_index.get(
                    f"{func.module.name}.{'.'.join(parts)}")
                return Resolved([tgt] if tgt else [])
            # method call through an object of unknown class: match by
            # terminal name (never a constructor)
            return Resolved(
                [t for t in self.name_index.get(f.attr, ())
                 if t.cls is not None and t.name != "__init__"])
        return Resolved([])

    # -- hot set ------------------------------------------------------------

    def _build_hot(self) -> None:
        work: List[FuncInfo] = []
        for f in self.func_index.values():
            if f.name in HOT_SEEDS or f.hot_annotated:
                f.hot = True
                work.append(f)
        while work:
            f = work.pop()
            for node in ast.walk(f.node):
                if not isinstance(node, ast.Call):
                    continue
                for t in self.resolve_call(f, node).targets:
                    if t is not None and not t.hot:
                        t.hot = True
                        work.append(t)


def _flatten(expr: ast.expr) -> List[str]:
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return list(reversed(parts))
    return []


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
            continue
        for sub in SCAN_SUBDIRS:
            root = os.path.join(p, sub)
            if not os.path.isdir(root):
                continue
            for dirpath, _dirs, files in os.walk(root):
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(files) if f.endswith(".py"))
    return sorted(set(out))


def iter_cu_files(paths: Sequence[str]) -> List[str]:
    """The CUDA sources beside the linted code: ``<root>/csrc/*.cu`` of
    a package root; for a file, the ``.cu`` files of its own directory,
    else of the ``csrc`` directory of the nearest package above it."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            dirs = [os.path.join(p, CSRC_SUBDIR)]
        elif p.endswith(".cu"):
            out.append(p)
            continue
        else:
            here = os.path.dirname(os.path.abspath(p))
            dirs = [here]
            up = here
            while not _has_cu(up) and os.path.dirname(up) != up:
                up = os.path.dirname(up)
                if _has_cu(os.path.join(up, CSRC_SUBDIR)):
                    dirs.append(os.path.join(up, CSRC_SUBDIR))
                    break
        for d in dirs:
            if os.path.isdir(d):
                out.extend(os.path.join(d, f) for f in sorted(os.listdir(d))
                           if f.endswith(".cu"))
    return sorted(set(out))


def _has_cu(d: str) -> bool:
    return os.path.isdir(d) and any(f.endswith(".cu") for f in os.listdir(d))


def _module_name(path: str) -> str:
    norm = os.path.abspath(path).replace(os.sep, "/")
    stem = norm[:-3] if norm.endswith(".py") else norm
    if "/repro_torch/" in stem:
        return "repro_torch." + stem.split("/repro_torch/", 1)[1].replace(
            "/", ".")
    return os.path.basename(stem)


def build_project(paths: Sequence[str]) -> Project:
    modules: Dict[str, ModuleInfo] = {}
    for path in iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        name = _module_name(path)
        rel = os.path.relpath(path)
        modules[name] = ModuleInfo(name, rel, source)
    return Project(modules, [os.path.relpath(p)
                             for p in iter_cu_files(paths)])


def run_rules(project: Project) -> List[Finding]:
    from repro_torch.analysis import rules
    findings: List[Finding] = []
    for rule in rules.ALL_RULES:
        findings.extend(rule.check(project))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint(paths: Sequence[str]) -> List[Finding]:
    return run_rules(build_project(paths))


def suppressed_sync_sites(paths: Sequence[str]
                          ) -> Dict[Tuple[str, str], bool]:
    """Every (file basename, function name) site whose sync the lint
    found under a ``# hotlint: sync`` comment, and whether any of its
    suppressions there is counted."""
    from repro_torch.analysis.rules import host_sync
    project = build_project(paths)
    sites: Dict[Tuple[str, str], bool] = {}
    for path, func, counted in host_sync.suppressed_sites(project):
        key = (os.path.basename(path), func)
        sites[key] = sites.get(key, False) or counted
    return sites


def collect_sync_sites(paths: Sequence[str]) -> Set[Tuple[str, str]]:
    """Static counterpart of the runtime sync ledger: the (file basename,
    function name) sites carrying a *counted* ``# hotlint: sync`` comment."""
    return {site for site, counted in suppressed_sync_sites(paths).items()
            if counted}


def load_baseline(path: Optional[str]) -> Set[str]:
    if not path or not os.path.exists(path):
        return set()
    with open(path, "r", encoding="utf-8") as fh:
        return {line.strip() for line in fh
                if line.strip() and not line.startswith("#")}
