"""HL002: a device tensor that a captured CUDA graph reads is rebound.

The port's counterpart of the reference's use-after-donation rule.  A
captured graph replays on the addresses it captured; an engine that
rebinds ``self.logits = ...`` after the capture leaves the graph
decoding from the old tensor, silently.  So in a class that captures a
graph (one of its methods builds an object of a graph class, a class
that builds ``torch.cuda.CUDAGraph`` itself or through a base, such as
``DecodeGraph`` or ``SpecGraph``), an assignment ``self.<attr> = ...``
to an attribute of its ``_DEVICE_STATE`` outside ``__init__`` is a
finding, and so is a call that passes ``self`` to a helper that rebinds
that attribute of its parameter (``engine.logits = ...``), directly or
through a helper of its own.  Everything such a graph reads is written
in place (``copy_``, ``fill_``, an indexed write).  Augmented
assignments (``self.x += y``) are in place on a tensor and pass.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.hotlint import ClassInfo, Finding, FuncInfo, Project
from repro_torch.analysis.rules.host_sync import graph_classes


def check(project: Project) -> List[Finding]:
    graphs = graph_classes(project)
    rebinds = _param_rebinds(project)
    findings: List[Finding] = []
    for cls in project.class_index.values():
        if not _captures(project, cls, graphs):
            continue
        state: Set[str] = set()
        for c in project.mro(cls):
            state.update(c.module.device_state.get(c.name, ()))
        if not state:
            continue
        for c in project.mro(cls):
            for func in c.module.functions.values():
                if func.cls != c.name or func.name == "__init__":
                    continue
                findings.extend(_check_method(project, cls, func, state,
                                              rebinds))
    return findings


def _captures(project: Project, cls: ClassInfo, graphs: Set[str]) -> bool:
    """Whether a method of ``cls`` (or of a base) builds a graph object."""
    for c in project.mro(cls):
        for func in c.module.functions.values():
            if func.cls != c.name:
                continue
            for node in ast.walk(func.node):
                built = project.built_class(func, node)
                if built is not None and built.full in graphs:
                    return True
    return False


def _self_targets(stmt: ast.stmt, name: str = "self") -> List[Tuple[str, int]]:
    """(attr, line) of every ``<name>.<attr> = ...`` target of ``stmt``."""
    out: List[Tuple[str, int]] = []

    def add(t) -> None:
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == name):
            out.append((t.attr, t.lineno))
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add(e)
        elif isinstance(t, ast.Starred):
            add(t.value)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            add(t)
    elif isinstance(stmt, ast.AnnAssign):
        add(stmt.target)
    return out


def _param_rebinds(project: Project) -> Dict[str, Dict[int, Set[str]]]:
    """For every function: positional parameter index -> the attributes
    it rebinds on that parameter, directly or by passing the parameter
    on to a function that does (a fixpoint over the call graph)."""
    out: Dict[str, Dict[int, Set[str]]] = {}
    for func in project.func_index.values():
        params = func.pos_params()
        direct: Dict[int, Set[str]] = {}
        for i, p in enumerate(params):
            if p == "self":
                continue
            for node in ast.walk(func.node):
                if isinstance(node, ast.stmt):
                    for attr, _ in _self_targets(node, p):
                        direct.setdefault(i, set()).add(attr)
        out[func.full] = direct
    changed = True
    while changed:
        changed = False
        for func in project.func_index.values():
            params = func.pos_params()
            for node in ast.walk(func.node):
                if not isinstance(node, ast.Call):
                    continue
                for tgt, idx, arg in _passed(project, func, node):
                    if not (isinstance(arg, ast.Name) and arg.id in params
                            and arg.id != "self"):
                        continue
                    got = out.get(tgt.full, {}).get(idx, set())
                    mine = out[func.full].setdefault(params.index(arg.id),
                                                     set())
                    if not got <= mine:
                        mine.update(got)
                        changed = True
    return out


def _passed(project: Project, func: FuncInfo, call: ast.Call):
    """(target, its positional parameter index, the argument) for each
    positional or keyword argument of ``call``, over its resolved
    targets."""
    out = []
    for tgt in project.resolve_call(func, call).targets:
        if tgt is None:
            continue
        params = tgt.pos_params()
        offset = 1 if params[:1] == ["self"] else 0
        for i, a in enumerate(call.args):
            if not isinstance(a, ast.Starred):
                out.append((tgt, i + offset, a))
        for k in call.keywords:
            if k.arg in params:
                out.append((tgt, params.index(k.arg), k.value))
    return out


def _check_method(project: Project, cls: ClassInfo, func: FuncInfo,
                  state: Set[str], rebinds) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[int, str]] = set()

    def add(line: int, message: str) -> None:
        if (line, message) not in seen:
            seen.add((line, message))
            out.append(Finding("HL002", func.module.path, line,
                               func.qualname, message))

    for node in ast.walk(func.node):
        if isinstance(node, ast.stmt):
            for attr, line in _self_targets(node):
                if attr in state:
                    add(line, f"rebinds self.{attr}, which {cls.name}'s "
                              f"captured graph reads: write it in place")
        if isinstance(node, ast.Call):
            for tgt, idx, arg in _passed(project, func, node):
                if not (isinstance(arg, ast.Name) and arg.id == "self"):
                    continue
                for attr in sorted(rebinds.get(tgt.full, {}).get(idx, set())
                                   & state):
                    add(node.lineno,
                        f"{tgt.qualname}() rebinds self.{attr}, which "
                        f"{cls.name}'s captured graph reads: write it in "
                        f"place")
    return out
