"""Shared AST/dataflow core for `repro_torch.analysis`.

The port's copy of ``repro.analysis.dataflow`` (pure ``ast``).  Builds
assignment-level dataflow facts from *parsed source files* (never
``inspect.getsource`` of a single function — whole-file parsing keeps AST
line numbers equal to real file lines, which is what gives every extracted
edge honest ``file:line`` provenance).

This module supersedes the `_DepVisitor` of the reference's deprecated
``quale_ast`` walker and fixes its two known gaps:

* ``AugAssign`` / ``AnnAssign`` (and ``for``-loop / ``with``-as) targets are
  recorded, not silently dropped;
* string *constants* are never treated as name reads (the old visitor
  recorded every ``ast.Constant`` string in an expression as a dataflow
  source, so ``hw["sa_dim"]`` polluted the dep set with both ``hw`` and a
  phantom name ``sa_dim``).  Here a subscript with a constant-string key on
  a named base becomes a typed *key read* ``base[key]`` instead.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


class AnalysisError(RuntimeError):
    """Raised when analyzed source does not match an anticipated shape.

    Extraction fails loudly (CI's ``extract --check`` turns red) instead of
    silently emitting a wrong influence graph after a perfmodel refactor.
    """


def repo_relative(path: str) -> str:
    """Render an absolute source path repo-relative (from the last ``src/``
    component) so provenance strings are stable across checkouts."""
    parts = Path(path).parts
    if "src" in parts:
        i = len(parts) - 1 - tuple(reversed(parts)).index("src")
        return "/".join(parts[i:])
    return Path(path).name


@dataclasses.dataclass(frozen=True)
class Site:
    """A ``file:line`` provenance anchor (file is repo-relative)."""

    file: str
    line: int

    def __str__(self) -> str:
        return f"{self.file}:{self.line}"


@dataclasses.dataclass(frozen=True)
class Read:
    """One dataflow source inside an expression.

    kind:
      * ``"name"`` — a plain identifier read;
      * ``"key"``  — ``base[name]`` with a constant-string key;
      * ``"attr"`` — ``base.name`` attribute read.
    """

    kind: str
    name: str
    base: Optional[str]
    site: Site


def expr_reads(node: ast.AST, file: str) -> List[Read]:
    """All reads in an expression, typed.  Subscript/attribute *bases* are
    folded into the typed read instead of leaking as extra plain names, and
    string constants are data, never names."""
    out: List[Read] = []
    skip: set = set()

    for sub in ast.walk(node):
        if id(sub) in skip:
            continue
        if isinstance(sub, ast.Subscript) and isinstance(sub.value, ast.Name):
            key = sub.slice
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                out.append(Read("key", key.value, sub.value.id,
                                Site(file, sub.lineno)))
                skip.add(id(sub.value))
                skip.add(id(key))
        elif isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name):
            out.append(Read("attr", sub.attr, sub.value.id,
                            Site(file, sub.lineno)))
            skip.add(id(sub.value))

    for sub in ast.walk(node):
        if id(sub) in skip:
            continue
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            out.append(Read("name", sub.id, None, Site(file, sub.lineno)))
    return out


# --------------------------------------------------------------------------
# per-function facts
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FunctionInfo:
    """Assignment-level dataflow facts for one function."""

    module: str
    qualname: str                  # "fn" or "Class.fn"
    name: str
    cls: Optional[str]
    params: Tuple[str, ...]        # excludes a leading self/cls
    node: ast.AST
    file: str                      # repo-relative
    # local name -> every RHS expression ever assigned to it (Assign,
    # AugAssign, AnnAssign, for-targets, with-as), with its site
    assigns: Dict[str, List[Tuple[ast.expr, Site]]] = \
        dataclasses.field(default_factory=dict)
    returns: List[Tuple[ast.expr, Site]] = dataclasses.field(default_factory=list)
    # constant-string-keyed dict-literal returns: key -> (value expr, site)
    dict_returns: Dict[str, Tuple[ast.expr, Site]] = \
        dataclasses.field(default_factory=dict)

    def local_exprs(self, name: str) -> List[Tuple[ast.expr, Site]]:
        return self.assigns.get(name, [])


def _record_target(info: FunctionInfo, target: ast.expr, value: ast.expr,
                   site: Site) -> None:
    if isinstance(target, ast.Name):
        info.assigns.setdefault(target.id, []).append((value, site))
    elif isinstance(target, (ast.Tuple, ast.List)):
        elts = target.elts
        if isinstance(value, (ast.Tuple, ast.List)) and \
                len(value.elts) == len(elts):
            for t, v in zip(elts, value.elts):
                _record_target(info, t, v, site)
        else:
            for t in elts:
                _record_target(info, t, value, site)
    # attribute/subscript targets (self.x = ..) are object state, not locals


def _build_function(module: str, qualname: str, cls: Optional[str],
                    node: ast.AST, file: str) -> FunctionInfo:
    args = node.args
    params = [a.arg for a in
              (args.posonlyargs + args.args + args.kwonlyargs)]
    if cls is not None and params and params[0] in ("self", "cls"):
        params = params[1:]
    info = FunctionInfo(module=module, qualname=qualname, name=node.name,
                        cls=cls, params=tuple(params), node=node, file=file)

    for sub in ast.walk(node):
        site = Site(file, getattr(sub, "lineno", node.lineno))
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                _record_target(info, t, sub.value, site)
        elif isinstance(sub, ast.AugAssign):
            # target reads both its prior value and the RHS; record the RHS
            # (prior assignments are already in the list for this name)
            _record_target(info, sub.target, sub.value, site)
        elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
            _record_target(info, sub.target, sub.value, site)
        elif isinstance(sub, ast.For):
            _record_target(info, sub.target, sub.iter, site)
        elif isinstance(sub, ast.With):
            for item in sub.items:
                if item.optional_vars is not None:
                    _record_target(info, item.optional_vars,
                                   item.context_expr, site)
        elif isinstance(sub, ast.Return) and sub.value is not None:
            info.returns.append((sub.value, site))
            if isinstance(sub.value, ast.Dict):
                for k, v in zip(sub.value.keys, sub.value.values):
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        info.dict_returns[k.value] = (v, Site(file, v.lineno))
    return info


# --------------------------------------------------------------------------
# per-module / cross-module index
# --------------------------------------------------------------------------

def iter_functions(tree: ast.Module) -> Iterator[Tuple[str, Optional[str], ast.AST]]:
    """Yield (qualname, class_name, node) for every def in a module AST,
    including methods (one class level deep — the repo's code shape)."""
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield stmt.name, None, stmt
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{stmt.name}.{sub.name}", stmt.name, sub


@dataclasses.dataclass
class ModuleInfo:
    name: str                       # full module name
    file: str                       # repo-relative
    tree: ast.Module
    functions: Dict[str, FunctionInfo]          # by qualname AND bare name
    constants: Dict[str, Tuple[object, Site]]   # module-level literal consts
    imports: Dict[str, Tuple[str, Optional[str]]]
    # local alias -> (module name, original symbol or None for module imports)


def _module_constants(tree: ast.Module, file: str) -> Dict[str, Tuple[object, Site]]:
    out: Dict[str, Tuple[object, Site]] = {}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        site = Site(file, stmt.lineno)
        for target in stmt.targets:
            if isinstance(target, ast.Name) and \
                    isinstance(stmt.value, ast.Constant):
                out[target.id] = (stmt.value.value, site)
            elif isinstance(target, ast.Name) and \
                    isinstance(stmt.value, ast.Tuple) and \
                    all(isinstance(e, ast.Constant) for e in stmt.value.elts):
                out[target.id] = (
                    tuple(e.value for e in stmt.value.elts), site)
            elif isinstance(target, ast.Tuple) and \
                    isinstance(stmt.value, ast.Tuple) and \
                    len(target.elts) == len(stmt.value.elts):
                for t, v in zip(target.elts, stmt.value.elts):
                    if isinstance(t, ast.Name) and isinstance(v, ast.Constant):
                        out[t.id] = (v.value, site)
    return out


def _module_imports(tree: ast.Module) -> Dict[str, Tuple[str, Optional[str]]]:
    out: Dict[str, Tuple[str, Optional[str]]] = {}
    for stmt in ast.walk(tree):
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                local = alias.asname or alias.name.split(".")[0]
                out[local] = (alias.name, None)
        elif isinstance(stmt, ast.ImportFrom) and stmt.module:
            for alias in stmt.names:
                local = alias.asname or alias.name
                out[local] = (stmt.module, alias.name)
    return out


class ModuleIndex:
    """Parsed-source index over a set of modules with interprocedural
    function/constant resolution."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}

    @classmethod
    def build(cls, modules: Sequence[ModuleType]) -> "ModuleIndex":
        idx = cls()
        for mod in modules:
            path = getattr(mod, "__file__", None)
            if path is None:
                raise AnalysisError(f"module {mod!r} has no source file")
            src = Path(path).read_text()
            tree = ast.parse(src)
            file = repo_relative(path)
            functions: Dict[str, FunctionInfo] = {}
            for qualname, cls_name, node in iter_functions(tree):
                info = _build_function(mod.__name__, qualname, cls_name,
                                       node, file)
                functions[qualname] = info
                # bare-name alias for methods, when unambiguous
                if cls_name is not None and node.name not in functions:
                    functions.setdefault(node.name, info)
            idx.modules[mod.__name__] = ModuleInfo(
                name=mod.__name__, file=file, tree=tree, functions=functions,
                constants=_module_constants(tree, file),
                imports=_module_imports(tree))
        return idx

    # -- resolution --------------------------------------------------------

    def module_of(self, info: FunctionInfo) -> ModuleInfo:
        return self.modules[info.module]

    def _imported_module(self, minfo: ModuleInfo,
                         local: str) -> Optional[ModuleInfo]:
        tgt = minfo.imports.get(local)
        if tgt is None:
            return None
        mod_name, orig = tgt
        if orig is not None:
            # "from pkg import workload as W" arrives as (pkg, workload)
            full = f"{mod_name}.{orig}"
            if full in self.modules:
                return self.modules[full]
        return self.modules.get(mod_name)

    def resolve_function(self, ctx: FunctionInfo, base: Optional[str],
                         name: str) -> Optional[FunctionInfo]:
        """Resolve a callee seen from inside ``ctx``: a plain name, an
        imported name, ``self.method``, or ``module_alias.fn``."""
        minfo = self.module_of(ctx)
        if base in ("self", "cls") and ctx.cls is not None:
            return minfo.functions.get(f"{ctx.cls}.{name}")
        if base is not None:
            target = self._imported_module(minfo, base)
            return target.functions.get(name) if target else None
        if name in minfo.functions:
            return minfo.functions[name]
        tgt = minfo.imports.get(name)
        if tgt is not None:
            mod_name, orig = tgt
            target = self.modules.get(mod_name)
            if target is not None and orig is not None:
                return target.functions.get(orig)
        return None

    def resolve_constant(self, ctx: FunctionInfo, base: Optional[str],
                         name: str) -> Optional[Tuple[object, Site]]:
        """Resolve ``name`` / ``alias.name`` to a module-level constant."""
        minfo = self.module_of(ctx)
        if base is not None:
            target = self._imported_module(minfo, base)
            return target.constants.get(name) if target else None
        if name in minfo.constants:
            return minfo.constants[name]
        tgt = minfo.imports.get(name)
        if tgt is not None:
            mod_name, orig = tgt
            target = self.modules.get(mod_name)
            if target is not None and orig is not None:
                return target.constants.get(orig)
        return None


# --------------------------------------------------------------------------
# call-site helpers
# --------------------------------------------------------------------------

def callee_parts(call: ast.Call) -> Tuple[Optional[str], Optional[str]]:
    """(base, name) of a call's target when it is a simple name or a
    one-level attribute; (None, None) otherwise."""
    f = call.func
    if isinstance(f, ast.Name):
        return None, f.id
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id, f.attr
    return None, None


def bind_args(callee: FunctionInfo, call: ast.Call) -> Dict[str, ast.expr]:
    """Map callee formal names -> actual argument expressions (positional +
    keyword; *args/**kwargs ignored — not used in the analyzed surface)."""
    binding: Dict[str, ast.expr] = {}
    for i, arg in enumerate(call.args):
        if i < len(callee.params):
            binding[callee.params[i]] = arg
    for kw in call.keywords:
        if kw.arg is not None:
            binding[kw.arg] = kw.value
    return binding
