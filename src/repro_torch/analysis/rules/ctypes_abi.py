"""HL004: the ctypes ABI of the hand-written kernels.

The port's counterpart of the reference's ``pallas_call`` arity rule.
The CUDA kernels are reached through ctypes (``kernels/build.py``), and
ctypes trusts the ``argtypes`` lists it is given: no compiler holds them
against the ``extern "C"`` signatures, and a list one entry short, or an
int where a pointer goes, passes garbage to the kernel.  So, read as
text and never compiled:

* every ``<lib>.<name>.argtypes = <list>`` is evaluated (lists of
  ctypes types, names bound to them, ``+`` and ``*`` by an int) and
  compared, position by position as pointer, int or float, with the
  ``extern "C"`` signature of ``<name>`` in the CUDA sources
  (``cudaStream_t`` and every ``T*`` are pointers);
* an ``argtypes`` for a name no source defines, or one without a
  ``restype``, is a finding;
* every call ``load_library().<name>(...)`` or ``lib.<name>(...)`` must
  pass as many arguments as the name's ``argtypes`` lists, and must
  have one.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.hotlint import Finding, FuncInfo, Project, _flatten

_EXTERN_RE = re.compile(
    r'extern\s+"C"\s+(?:__global__\s+)?[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
    re.S)
_POINTER_TYPES = {"c_void_p", "c_char_p", "c_wchar_p"}
_INT_TYPES = {"c_int", "c_uint", "c_int8", "c_uint8", "c_int16", "c_uint16",
              "c_int32", "c_uint32", "c_int64", "c_uint64", "c_long",
              "c_ulong", "c_longlong", "c_ulonglong", "c_size_t",
              "c_ssize_t", "c_short", "c_ushort", "c_bool", "c_char",
              "c_byte", "c_ubyte"}
_FLOAT_TYPES = {"c_float", "c_double", "c_longdouble"}
_C_INTS = {"int", "unsigned", "long", "short", "size_t", "int32_t",
           "int64_t", "uint32_t", "uint64_t", "int8_t", "uint8_t",
           "int16_t", "uint16_t", "bool", "char", "ptrdiff_t"}
_C_FLOATS = {"float", "double"}
_C_POINTERS = {"cudaStream_t", "cudaEvent_t"}


def check(project: Project) -> List[Finding]:
    sigs, sig_errors = c_signatures(project.cu_files)
    findings: List[Finding] = list(sig_errors)
    declared: Dict[str, int] = {}
    restyped = set()
    decls: List[Tuple[FuncInfo, ast.Assign, str, Optional[List[str]]]] = []
    for mod in project.modules.values():
        for func in mod.functions.values():
            env = _ctypes_env(func)
            for node in ast.walk(func.node):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    parts = _flatten(t)
                    if len(parts) >= 3 and parts[-1] == "argtypes":
                        kinds = _eval_list(node.value, env)
                        decls.append((func, node, parts[-2], kinds))
                    elif len(parts) >= 3 and parts[-1] == "restype":
                        restyped.add(parts[-2])

    def add(func: FuncInfo, line: int, message: str) -> None:
        findings.append(Finding("HL004", func.module.path, line,
                                func.qualname, message))

    for func, node, name, kinds in decls:
        if kinds is None:
            add(func, node.lineno,
                f"argtypes of {name} cannot be evaluated: build it from "
                f"lists of ctypes types, + and * by an int")
            continue
        declared[name] = len(kinds)
        if name not in restyped:
            add(func, node.lineno,
                f"{name} has argtypes but no restype: its return type is "
                f"left undeclared")
        sig = sigs.get(name)
        if sig is None:
            add(func, node.lineno,
                f"argtypes for {name}, which no extern \"C\" function of "
                f"the CUDA sources defines")
            continue
        path, want = sig
        if len(kinds) != len(want):
            add(func, node.lineno,
                f"argtypes of {name} list {len(kinds)} parameters, its "
                f"extern \"C\" signature in {path} has {len(want)}")
            continue
        for i, (have, c) in enumerate(zip(kinds, want)):
            if have != c:
                add(func, node.lineno,
                    f"argtypes of {name}: parameter {i} is a {have} in "
                    f"the list, a {c} in {path}")
    for mod in project.modules.values():
        for func in mod.functions.values():
            for node in ast.walk(func.node):
                if not isinstance(node, ast.Call):
                    continue
                name = _library_call(node)
                if name is None:
                    continue
                if name not in declared:
                    if name in sigs or name.startswith("repro_"):
                        add(func, node.lineno,
                            f"{name} is called through ctypes with no "
                            f"argtypes: its arguments go unchecked")
                    continue
                n = len(node.args)
                if any(isinstance(a, ast.Starred) for a in node.args):
                    continue
                if n != declared[name]:
                    add(func, node.lineno,
                        f"{name} called with {n} arguments, its argtypes "
                        f"list {declared[name]}")
    return findings


def c_signatures(paths) -> Tuple[Dict[str, Tuple[str, List[str]]],
                                 List[Finding]]:
    """``extern "C"`` functions of the CUDA sources: name -> (path,
    parameter kinds)."""
    out: Dict[str, Tuple[str, List[str]]] = {}
    errors: List[Finding] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as fh:
            text = _strip_comments(fh.read())
        for m in _EXTERN_RE.finditer(text):
            name, params = m.group(1), m.group(2).strip()
            kinds = []
            for p in ([] if params in ("", "void") else params.split(",")):
                kind = _c_kind(p)
                if kind is None:
                    line = text.count("\n", 0, m.start()) + 1
                    errors.append(Finding(
                        "HL004", path, line, name,
                        f"parameter '{p.strip()}' of {name} is neither a "
                        f"pointer, an int nor a float"))
                    kind = "?"
                kinds.append(kind)
            out[name] = (path, kinds)
    return out, errors


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"),
                  text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _c_kind(param: str) -> Optional[str]:
    p = param.strip()
    if "*" in p or "[" in p:
        return "pointer"
    words = [w for w in re.findall(r"\w+", p)
             if w not in ("const", "volatile", "signed", "struct")]
    types = words[:-1] if len(words) > 1 else words
    if any(w in _C_POINTERS for w in types):
        return "pointer"
    if any(w in _C_FLOATS for w in types):
        return "float"
    if types and all(w in _C_INTS for w in types):
        return "int"
    return None


def _ctypes_kind(expr, env: Dict[str, str]) -> Optional[str]:
    parts = _flatten(expr)
    if isinstance(expr, ast.Call):
        fn = _flatten(expr.func)
        if fn[-1:] == ["POINTER"]:
            return "pointer"
        return None
    if len(parts) == 1 and parts[0] in env:
        return env[parts[0]]
    name = parts[-1] if parts else ""
    if name in _POINTER_TYPES:
        return "pointer"
    if name in _INT_TYPES:
        return "int"
    if name in _FLOAT_TYPES:
        return "float"
    return None


def _ctypes_env(func: FuncInfo) -> Dict[str, str]:
    """Local names bound to ctypes types (``p, i = ctypes.c_void_p,
    ctypes.c_int``)."""
    env: Dict[str, str] = {}
    for node in ast.walk(func.node):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            pairs = []
            if isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple) \
                    and len(t.elts) == len(node.value.elts):
                pairs = list(zip(t.elts, node.value.elts))
            elif isinstance(t, ast.Name):
                pairs = [(t, node.value)]
            for n, v in pairs:
                if isinstance(n, ast.Name):
                    kind = _ctypes_kind(v, {})
                    if kind is not None:
                        env[n.id] = kind
    return env


def _eval_list(expr, env: Dict[str, str]) -> Optional[List[str]]:
    if isinstance(expr, (ast.List, ast.Tuple)):
        out = []
        for e in expr.elts:
            kind = _ctypes_kind(e, env)
            if kind is None:
                return None
            out.append(kind)
        return out
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        a, b = _eval_list(expr.left, env), _eval_list(expr.right, env)
        return None if a is None or b is None else a + b
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        for lst, n in ((expr.left, expr.right), (expr.right, expr.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                body = _eval_list(lst, env)
                return None if body is None else body * n.value
    return None


def _library_call(call: ast.Call) -> Optional[str]:
    """``<name>`` of ``load_library().<name>(...)`` or
    ``lib.<name>(...)``."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    base = f.value
    if isinstance(base, ast.Call) and _flatten(base.func)[-1:] == \
            ["load_library"]:
        return f.attr
    if isinstance(base, ast.Name) and base.id == "lib":
        return f.attr
    return None
