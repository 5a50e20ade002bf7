"""Invariant linter for the port's concurrency stack.

The port's counterpart of ``repro.analysis.lint``, with the reference's
rules (run as ``python -m repro_torch.analysis.lint [paths] --baseline
src/repro_torch/analysis/lint-baseline.json``).  The run fails only on
findings not recorded in the baseline, so intentional patterns are
accepted once — with a one-line justification — and every new occurrence
is a failure.

The two jit rules are the reference's and are kept as they are: the port
has no ``jax.jit`` (and no ``torch.compile``), so they find nothing in
its code.  ``host-sync-hot-loop`` reads a torch call (``torch.``) as a
device producer beside ``jnp.`` and jitted calls, and ``.item()``,
``.cpu()`` and ``.tolist()`` on such a value as pulls to the host.

Rules:

=====================  =====================================================
``mutable-default``    A function parameter default is a mutable literal or
                       constructor (the PR-6 ``RetryPolicy`` footgun).
``unlocked-shared-write``  In ``distributed/``/``serve/``: a class that owns
                       a lock mutates a container attribute outside any
                       ``with <lock>`` block (methods documented as
                       "caller holds the lock" are exempt).
``future-swallow``     A function that creates ``Future``\\ s has an
                       ``except`` handler that neither re-raises nor
                       resolves/cancels a future nor delegates to a
                       die/fail path — in-flight futures can hang forever.
``thread-not-daemon``  ``threading.Thread``/``Timer`` created without
                       ``daemon=True`` (kwarg or attribute before start):
                       leaked helpers block interpreter shutdown.
``executor-leak``      A ``ThreadPoolExecutor``/``ProcessPoolExecutor``
                       constructed outside ``with`` whose owner has no
                       visible ``.shutdown(`` path.
``jit-static-mutable`` ``jax.jit(..., static_argnums=[...])`` with a
                       mutable literal spec (unhashable-static hazard).
``jit-traced-branch``  A ``@jax.jit``-decorated function branches with
                       Python ``if``/``while`` on a traced parameter
                       (shape/isinstance/None checks are fine).
``host-sync-hot-loop`` Inside a loop, a value produced by torch/jnp/jitted
                       calls in that same loop is pulled to host
                       (``float()``/``np.asarray``/``.item()``/``.cpu()``/
                       ``.tolist()``/``block_until_ready``) — a
                       per-iteration device sync in a hot path.
``raw-telemetry-dict`` In ``distributed/``/``serve/``: a public ``self``
                       attribute zero-initialized in ``__init__`` (``= 0``
                       or a dict of zeros) is ``+=``-incremented — an
                       ad-hoc telemetry counter that should be a
                       :class:`repro_torch.obs.metrics.Counter` (typed, locked,
                       exported).  Underscore-prefixed attributes are
                       internal state, not telemetry, and are exempt.
=====================  =====================================================
"""
from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.dataflow import repo_relative

CONCURRENCY_SCOPES = ("distributed/", "serve/")

_MUTABLE_CTORS = {"list", "dict", "set", "deque", "defaultdict",
                  "OrderedDict", "bytearray", "Counter"}
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_CONTAINER_CTORS = {"list", "dict", "set", "deque", "defaultdict",
                    "OrderedDict", "Counter"}
_MUTATORS = {"append", "add", "update", "pop", "popitem", "popleft",
             "appendleft", "remove", "discard", "clear", "setdefault",
             "extend", "insert"}
_RESOLVERS = {"set_exception", "set_result", "cancel"}
_EXECUTORS = {"ThreadPoolExecutor", "ProcessPoolExecutor"}
_HOST_PULLS = {"float", "int", "asarray", "array", "item"}
# pulls as methods of the device value (block_until_ready is jax's)
_HOST_PULL_METHODS = {"block_until_ready", "item", "cpu", "tolist"}
_DEVICE_PREFIXES = ("jnp.", "torch.")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    file: str          # repo-relative
    line: int
    symbol: str        # enclosing qualname
    message: str

    @property
    def key(self) -> Tuple[str, str, str]:
        # line-free so refactors that shift code don't churn the baseline
        return (self.rule, self.file, self.symbol)

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.symbol}: " \
               f"{self.message}"


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_jit_expr(e: ast.expr) -> bool:
    """jax.jit / jit / functools.partial(jax.jit, ...)"""
    if isinstance(e, ast.Attribute) and e.attr == "jit":
        return True
    if isinstance(e, ast.Name) and e.id == "jit":
        return True
    if isinstance(e, ast.Call):
        if _call_name(e) in ("jit",):
            return True
        if _call_name(e) == "partial" and e.args and _is_jit_expr(e.args[0]):
            return True
        return _is_jit_expr(e.func)
    return False


def _iter_scopes(tree: ast.Module) -> Iterator[Tuple[str, ast.AST]]:
    """(qualname, node) for every function at any nesting depth."""
    def rec(node: ast.AST, prefix: str) -> Iterator[Tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from rec(child, f"{q}.")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
    yield from rec(tree, "")


def _docstring(node: ast.AST) -> str:
    try:
        return ast.get_docstring(node) or ""
    except TypeError:
        return ""


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------

def _rule_mutable_default(tree: ast.Module, file: str) -> Iterator[Finding]:
    for qual, fn in _iter_scopes(tree):
        defaults = list(fn.args.defaults) + \
            [d for d in fn.args.kw_defaults if d is not None]
        for d in defaults:
            bad = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and _call_name(d) in _MUTABLE_CTORS)
            if bad:
                yield Finding("mutable-default", file, d.lineno, qual,
                              "mutable default argument is shared across "
                              "calls")


def _self_attr(e: ast.expr) -> Optional[str]:
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) and \
            e.value.id == "self":
        return e.attr
    return None


def _mentions_lock(e: ast.expr, locks: Set[str]) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr in locks and
               isinstance(n.value, ast.Name) and n.value.id == "self"
               for n in ast.walk(e))


def _rule_unlocked_shared_write(tree: ast.Module,
                                file: str) -> Iterator[Finding]:
    if not any(s in file for s in CONCURRENCY_SCOPES):
        return
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        init = methods.get("__init__")
        if init is None:
            continue
        locks: Set[str] = set()
        containers: Set[str] = set()
        for stmt in ast.walk(init):
            if not isinstance(stmt, ast.Assign):
                continue
            for tgt in stmt.targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                rhs_calls = {_call_name(n) for n in ast.walk(stmt.value)
                             if isinstance(n, ast.Call)}
                if rhs_calls & _LOCK_CTORS:
                    locks.add(attr)
                elif isinstance(stmt.value, (ast.Dict, ast.List, ast.Set)) \
                        or rhs_calls & _CONTAINER_CTORS:
                    containers.add(attr)
        if not locks or not containers:
            continue

        for mname, m in methods.items():
            if mname == "__init__":
                continue
            doc = _docstring(m).lower()
            if "holds the lock" in doc or "caller holds" in doc or \
                    "lock held" in doc:
                continue

            def scan(node: ast.AST, locked: bool) -> Iterator[Finding]:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, ast.With):
                        l2 = locked or any(
                            _mentions_lock(item.context_expr, locks)
                            for item in child.items)
                        yield from scan(child, l2)
                        continue
                    if isinstance(child,
                                  (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                        continue    # nested callbacks judged on their own
                    if not locked:
                        w = _container_write(child, containers)
                        if w is not None:
                            attr, verb = w
                            yield Finding(
                                "unlocked-shared-write", file, child.lineno,
                                f"{cls.name}.{mname}",
                                f"self.{attr} {verb} outside a held lock "
                                f"(class owns {sorted(locks)})")
                    yield from scan(child, locked)

            yield from scan(m, locked=False)


def _container_write(node: ast.AST,
                     containers: Set[str]) -> Optional[Tuple[str, str]]:
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for tgt in targets:
            if isinstance(tgt, ast.Subscript):
                attr = _self_attr(tgt.value)
                if attr in containers:
                    return attr, "item-assigned"
            attr = _self_attr(tgt)
            if attr in containers:
                return attr, "rebound"
    if isinstance(node, ast.Delete):
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                attr = _self_attr(tgt.value)
                if attr in containers:
                    return attr, "item-deleted"
    if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
        f = node.value.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _self_attr(f.value)
            if attr in containers:
                return attr, f".{f.attr}()"
    return None


def _rule_future_swallow(tree: ast.Module, file: str) -> Iterator[Finding]:
    for qual, fn in _iter_scopes(tree):
        makes_future = any(
            isinstance(n, ast.Call) and _call_name(n) == "Future"
            for n in ast.walk(fn))
        if not makes_future:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.ExceptHandler):
                continue
            ok = False
            for sub in ast.walk(node):
                if isinstance(sub, ast.Raise):
                    ok = True
                elif isinstance(sub, ast.Call):
                    name = _call_name(sub)
                    if name in _RESOLVERS or (
                            name and ("die" in name or "fail" in name)):
                        ok = True
            if not ok:
                yield Finding(
                    "future-swallow", file, node.lineno, qual,
                    "except path neither re-raises nor resolves/fails the "
                    "pending future(s) created in this function")


def _rule_thread_not_daemon(tree: ast.Module, file: str) -> Iterator[Finding]:
    for qual, fn in _iter_scopes(tree):
        body = list(ast.walk(fn))
        # names whose .daemon is assigned True anywhere in this function
        daemonized: Set[str] = set()
        for node in body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    node.value.value is True:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            tgt.attr == "daemon":
                        daemonized.add(ast.unparse(tgt.value))
        for node in body:
            if not (isinstance(node, ast.Assign) and
                    isinstance(node.value, ast.Call) and
                    _call_name(node.value) in ("Thread", "Timer")):
                continue
            call = node.value
            if any(kw.arg == "daemon" for kw in call.keywords):
                continue
            tgt_names = {ast.unparse(t) for t in node.targets}
            if tgt_names & daemonized:
                continue
            yield Finding(
                "thread-not-daemon", file, node.lineno, qual,
                f"{_call_name(call)} created without daemon=True; a leaked "
                "helper blocks interpreter shutdown")


def _rule_executor_leak(tree: ast.Module, file: str) -> Iterator[Finding]:
    src_has_shutdown = any(
        isinstance(n, ast.Attribute) and n.attr == "shutdown"
        for n in ast.walk(tree))
    for qual, fn in _iter_scopes(tree):
        with_ctx: Set[int] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    for sub in ast.walk(item.context_expr):
                        with_ctx.add(id(sub))
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and
                    _call_name(node) in _EXECUTORS):
                continue
            if id(node) in with_ctx:
                continue
            if src_has_shutdown:
                # an explicit lifecycle exists somewhere in this file;
                # pairing construction to shutdown is the baseline's job
                continue
            yield Finding(
                "executor-leak", file, node.lineno, qual,
                f"{_call_name(node)} constructed outside `with` and no "
                ".shutdown( anywhere in this file")


def _rule_jit_static_mutable(tree: ast.Module, file: str) -> Iterator[Finding]:
    for qual, fn in _iter_scopes(tree):
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and _is_jit_expr(node.func)
                    or isinstance(node, ast.Call) and
                    _is_jit_expr(node)):
                continue
            for kw in getattr(node, "keywords", ()):
                if kw.arg in ("static_argnums", "static_argnames") and \
                        isinstance(kw.value, (ast.List, ast.Dict, ast.Set)):
                    yield Finding(
                        "jit-static-mutable", file, kw.value.lineno, qual,
                        f"{kw.arg} given as a mutable literal; use a tuple "
                        "(static specs are hashed into the jit cache key)")


def _rule_jit_traced_branch(tree: ast.Module, file: str) -> Iterator[Finding]:
    for qual, fn in _iter_scopes(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        jitted = any(_is_jit_expr(d) for d in fn.decorator_list)
        if not jitted:
            continue
        static: Set[str] = set()
        for d in fn.decorator_list:
            if isinstance(d, ast.Call):
                for kw in d.keywords:
                    if kw.arg == "static_argnames":
                        for n in ast.walk(kw.value):
                            if isinstance(n, ast.Constant) and \
                                    isinstance(n.value, str):
                                static.add(n.value)
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs} - static
        for node in ast.walk(fn):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            test = node.test
            reads = {n.id for n in ast.walk(test)
                     if isinstance(n, ast.Name)}
            if not reads & params:
                continue
            benign = any(
                (isinstance(n, ast.Call) and
                 _call_name(n) in ("isinstance", "len", "hasattr")) or
                (isinstance(n, ast.Attribute) and
                 n.attr in ("shape", "ndim", "dtype", "size")) or
                (isinstance(n, ast.Constant) and n.value is None)
                for n in ast.walk(test))
            if benign:
                continue
            yield Finding(
                "jit-traced-branch", file, node.lineno, qual,
                "Python branch on a traced argument inside a jitted "
                "function (TracerBoolConversionError / silent retrace)")


def _rule_host_sync_hot_loop(tree: ast.Module, file: str) -> Iterator[Finding]:
    for qual, fn in _iter_scopes(tree):
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            device_locals: Set[str] = set()
            for node in ast.walk(loop):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    fsrc = ast.unparse(node.value.func)
                    if fsrc.startswith(_DEVICE_PREFIXES) or \
                            "jit" in fsrc.lower():
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                device_locals.add(tgt.id)
            if not device_locals:
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                pulled = None
                if name in _HOST_PULLS and node.args and \
                        isinstance(node.args[0], ast.Name) and \
                        node.args[0].id in device_locals:
                    pulled = node.args[0].id
                elif name in _HOST_PULL_METHODS and \
                        isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id in device_locals:
                    pulled = node.func.value.id
                if pulled:
                    yield Finding(
                        "host-sync-hot-loop", file, node.lineno, qual,
                        f"`{pulled}` is computed on device and pulled to "
                        "host every iteration of this loop")


def _is_zero_counter_init(value: ast.expr) -> bool:
    """`= 0`, `= {...: 0}` or `= {k: 0 for ...}` — the ad-hoc counter
    initialization shapes the registry replaces."""
    if isinstance(value, ast.Constant):
        return value.value == 0 and not isinstance(value.value, bool)
    if isinstance(value, ast.Dict):
        return bool(value.values) and all(
            isinstance(v, ast.Constant) and v.value == 0
            for v in value.values)
    if isinstance(value, ast.DictComp):
        return isinstance(value.value, ast.Constant) and \
            value.value.value == 0
    return False


def _rule_raw_telemetry_dict(tree: ast.Module,
                             file: str) -> Iterator[Finding]:
    if not any(s in file for s in CONCURRENCY_SCOPES):
        return
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        init = methods.get("__init__")
        if init is None:
            continue
        counters: Set[str] = set()
        for stmt in ast.walk(init):
            if not isinstance(stmt, ast.Assign):
                continue
            for tgt in stmt.targets:
                attr = _self_attr(tgt)
                if attr is None or attr.startswith("_"):
                    continue
                if _is_zero_counter_init(stmt.value):
                    counters.add(attr)
        if not counters:
            continue
        for mname, m in methods.items():
            if mname == "__init__":
                continue
            for node in ast.walk(m):
                if not isinstance(node, ast.AugAssign):
                    continue
                tgt = node.target
                attr = _self_attr(tgt)
                if attr is None and isinstance(tgt, ast.Subscript):
                    attr = _self_attr(tgt.value)
                if attr in counters:
                    yield Finding(
                        "raw-telemetry-dict", file, node.lineno,
                        f"{cls.name}.{mname}",
                        f"self.{attr} is an ad-hoc telemetry counter "
                        "(zero-initialized in __init__, incremented here); "
                        "register a repro_torch.obs.metrics Counter instead")


_PICKLE_LOADERS = {"loads", "load", "Unpickler"}


def _rule_pickle_outside_codec(tree: ast.Module,
                               file: str) -> Iterator[Finding]:
    """Pickle DESERIALIZATION on the serve/distributed surface is remote
    code execution for whoever owns the bytes; the only sanctioned sites
    are ``serve/codec.py``'s shims (``legacy_loads`` and the
    allowlist-restricted unpickler) — everything else must route through
    them or carry a baseline entry for an intentional single-trust-domain
    use."""
    if not any(s in file for s in CONCURRENCY_SCOPES):
        return
    if file.replace("\\", "/").endswith("serve/codec.py"):
        return                          # the sanctioned shim module
    aliases = {"pickle"}
    bare: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "pickle":
                    aliases.add(a.asname or "pickle")
        elif isinstance(node, ast.ImportFrom) and node.module == "pickle":
            for a in node.names:
                if a.name in _PICKLE_LOADERS:
                    bare.add(a.asname or a.name)

    def hit(call: ast.Call) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _PICKLE_LOADERS and \
                isinstance(f.value, ast.Name) and f.value.id in aliases:
            return f"pickle.{f.attr}"
        if isinstance(f, ast.Name) and f.id in bare:
            return f.id
        return None

    def visit(node: ast.AST, qual: str) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child,
                          (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
                inner = (child.name if qual == "<module>"
                         else f"{qual}.{child.name}")
                yield from visit(child, inner)
                continue
            for n in ast.walk(child):
                if isinstance(n, ast.Call):
                    name = hit(n)
                    if name is not None:
                        yield Finding(
                            "pickle-outside-codec", file, n.lineno, qual,
                            f"{name} deserializes attacker-controlled "
                            "bytes into arbitrary objects; route through "
                            "repro_torch.serve.codec (restricted_loads / "
                            "legacy_loads) instead")

    yield from visit(tree, "<module>")


_RULES = (
    _rule_mutable_default,
    _rule_unlocked_shared_write,
    _rule_future_swallow,
    _rule_thread_not_daemon,
    _rule_executor_leak,
    _rule_jit_static_mutable,
    _rule_jit_traced_branch,
    _rule_host_sync_hot_loop,
    _rule_raw_telemetry_dict,
    _rule_pickle_outside_codec,
)

RULE_NAMES = ("mutable-default", "unlocked-shared-write", "future-swallow",
              "thread-not-daemon", "executor-leak", "jit-static-mutable",
              "jit-traced-branch", "host-sync-hot-loop",
              "raw-telemetry-dict", "pickle-outside-codec")


# --------------------------------------------------------------------------
# running the rules over files, the baseline, the CLI
# --------------------------------------------------------------------------

def lint_file(path: Path) -> List[Finding]:
    try:
        tree = ast.parse(path.read_text())
    except SyntaxError as exc:
        return [Finding("syntax-error", repo_relative(str(path)),
                        exc.lineno or 0, "<module>", str(exc))]
    file = repo_relative(str(path))
    out: List[Finding] = []
    for rule in _RULES:
        out.extend(rule(tree, file))
    return sorted(out, key=lambda f: (f.file, f.line, f.rule))


def lint_paths(paths: Sequence[Path]) -> List[Finding]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    out: List[Finding] = []
    for f in files:
        out.extend(lint_file(f))
    return out


def load_baseline(path: Path) -> Dict[Tuple[str, str, str], str]:
    """(rule, file, symbol) -> justification."""
    if not Path(path).exists():
        return {}
    data = json.loads(Path(path).read_text())
    return {(f["rule"], f["file"], f["symbol"]): f.get("justification", "")
            for f in data.get("findings", [])}


def write_baseline(path: Path, findings: Sequence[Finding],
                   old: Optional[Dict[Tuple[str, str, str], str]] = None
                   ) -> None:
    old = old or {}
    seen = set()
    rows = []
    for f in findings:
        if f.key in seen:
            continue
        seen.add(f.key)
        rows.append({"rule": f.rule, "file": f.file, "symbol": f.symbol,
                     "justification": old.get(f.key, "TODO: justify")})
    Path(path).write_text(json.dumps(
        {"version": 1, "findings": rows}, indent=2) + "\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-tuned concurrency invariant linter")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="accepted-findings file; only NEW findings fail")
    ap.add_argument("--write-baseline", type=Path, default=None,
                    help="write current findings as the new baseline")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    args = ap.parse_args(argv)

    findings = lint_paths([Path(p) for p in args.paths])

    if args.write_baseline is not None:
        old = load_baseline(args.baseline) if args.baseline else {}
        write_baseline(args.write_baseline, findings, old)
        print(f"wrote {args.write_baseline} "
              f"({len({f.key for f in findings})} accepted keys)")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else {}
    new = [f for f in findings if f.key not in baseline]
    accepted = [f for f in findings if f.key in baseline]
    stale = set(baseline) - {f.key for f in findings}

    if args.json:
        print(json.dumps({
            "new": [dataclasses.asdict(f) for f in new],
            "accepted": [dataclasses.asdict(f) for f in accepted],
            "stale_baseline_keys": sorted(map(list, stale)),
        }, indent=2))
    else:
        for f in new:
            print(f"NEW  {f}")
        if accepted:
            print(f"({len(accepted)} accepted finding(s) in baseline)")
        for key in sorted(stale):
            print(f"stale baseline entry (no longer fires): {key}")
        print(f"{len(new)} new finding(s), {len(findings)} total")
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
