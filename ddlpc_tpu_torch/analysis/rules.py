"""The project AST rules — the port's copy of ``ddlpc_tpu/analysis/rules.py``.

Each rule is one class; all of them run off one shared AST walk
(:mod:`core`).  Rules are deliberately *syntactic*: they prove the idioms
the repo's contracts are written in, not arbitrary data flow, and every
escape hatch is an inline suppression with a written reason.

``jsonl-stamp``, ``atomic-write`` and ``metric-doc`` work as JAX's do
(``tests/test_torch_analysis.py`` holds them to JAX's on the same
fixtures).  ``metric-doc`` reads ``docs/OBSERVABILITY.md``, which the port
shares with the JAX package, and does not take the C entry points that
``kernels/build.py:_SIGNATURES`` declares (``ddlpc_encode_i8``, ...) for
metrics.  ``jit-host-call`` and ``codec-fence`` take the port's form: the
port runs eagerly, so what they guard is a function that a compiler or a
CUDA graph captures (``torch.compile``, ``torch.jit.script``/``trace``,
``torch.cuda.make_graphed_callables``, a ``with torch.cuda.graph(...)``
body).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from ddlpc_tpu_torch.analysis.core import PACKAGE, FileContext, Rule, Violation


def _call_name(node: ast.AST) -> str:
    """Dotted name of a call target: ``json.dumps`` / ``open`` / ``fq``."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


def _is_json_dumps(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _call_name(node.func) in ("json.dumps", "dumps")


def _is_json_loads(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _call_name(node.func) in ("json.loads", "loads")


class _CollectingRule(Rule):
    """A rule whose per-file hits are surfaced at ``finalize``."""

    def __init__(self):
        self._violations: List[Violation] = []

    def hit(self, path: str, line: int, message: str) -> None:
        self._violations.append(Violation(self.id, path, line, message))

    def finalize(self, root: str) -> List[Violation]:
        out, self._violations = self._violations, []
        return out


class JsonlStampRule(_CollectingRule):
    """jsonl-stamp: a ``f.write(json.dumps(rec) + "\\n")`` emit site must
    stamp the record (``obs.schema.stamp``, an explicit ``"schema"`` key,
    or ``setdefault("schema", ...)`` in the same function).  Pass-throughs
    that re-emit decoded lines (``json.loads`` inside the dumped
    expression) are exempt: the stamp rode in on the original record."""

    id = "jsonl-stamp"
    doc = (
        "JSONL emit sites must flow through a schema-stamping helper "
        "(obs/schema.py:stamp) so every stream lints clean"
    )

    def visit_Call(self, node: ast.Call, ctx: FileContext) -> None:
        # shape: <something>.write( json.dumps(...) [+ "\n"] )
        if not (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "write"
            and len(node.args) == 1
        ):
            return
        arg = node.args[0]
        dumped: Optional[ast.Call] = None
        if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add):
            if _is_json_dumps(arg.left):
                dumped = arg.left
        elif _is_json_dumps(arg):
            dumped = arg
        if dumped is None:
            return
        if any(kw.arg == "indent" for kw in dumped.keywords):
            return  # pretty-printed report JSON, not a JSONL stream
        if any(_is_json_loads(n) for n in ast.walk(dumped)):
            return  # pass-through of an already-stamped record
        func = ctx.enclosing_function(node)
        if _has_stamp_evidence(func if func is not None else ctx.tree):
            return
        self.hit(
            ctx.path, node.lineno,
            "JSONL record written without schema stamping — build the record via "
            "obs.schema.stamp(...) (or set 'schema' explicitly in this function)",
        )


def _has_stamp_evidence(scope: ast.AST) -> bool:
    for n in ast.walk(scope):
        if isinstance(n, ast.Call):
            name = _call_name(n.func)
            if name in ("stamp", "schema.stamp") or name.endswith(".stamp"):
                return True
            if (
                isinstance(n.func, ast.Attribute)
                and n.func.attr == "setdefault"
                and n.args
                and isinstance(n.args[0], ast.Constant)
                and n.args[0].value == "schema"
            ):
                return True
        if isinstance(n, ast.Dict):
            for k in n.keys:
                if isinstance(k, ast.Constant) and k.value == "schema":
                    return True
        if (
            isinstance(n, ast.Assign)
            and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Subscript)
        ):
            s = n.targets[0].slice
            if isinstance(s, ast.Constant) and s.value == "schema":
                return True
    return False


class AtomicWriteRule(_CollectingRule):
    """atomic-write: report and metadata JSONs go to disk by tmp + rename
    (``utils.fsio.atomic_write_json``, or a function that performs
    ``os.replace`` itself), never a bare ``open(path, "w")``: a crash
    mid-write must not leave a torn file where a reader expects a whole
    one."""

    id = "atomic-write"
    doc = (
        "JSON report writes use the tmp+rename helpers (utils/fsio.py), "
        "never bare open(..., 'w')"
    )

    def _function_is_atomic(self, scope: ast.AST) -> bool:
        # ``os.replace`` in the same function marks a self-rolled atomic
        # writer: rename-atomicity (no torn reads) is what this rule
        # proves; fsync is the helpers' separate durability decision.
        return any(
            isinstance(n, ast.Call)
            and _call_name(n.func) in ("os.replace", "os.rename", "replace")
            for n in ast.walk(scope)
        )

    def _open_w_names(self, scope: ast.AST) -> Dict[str, int]:
        """Names bound to a bare ``open(..., 'w'/'wb')`` in this scope
        (with-items and assignments)."""
        names: Dict[str, int] = {}

        def mode_of(call: ast.Call) -> str:
            if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
                return str(call.args[1].value)
            for kw in call.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    return str(kw.value.value)
            return "r"

        for n in ast.walk(scope):
            call = None
            target = None
            if isinstance(n, ast.withitem) and isinstance(n.context_expr, ast.Call):
                call, target = n.context_expr, n.optional_vars
            elif isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                call = n.value
                if len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                    target = n.targets[0]
            if (
                call is not None
                and _call_name(call.func) == "open"
                and "w" in mode_of(call)
                and isinstance(target, ast.Name)
            ):
                names[target.id] = call.lineno
        return names

    def visit_Call(self, node: ast.Call, ctx: FileContext) -> None:
        func = ctx.enclosing_function(node)
        scope = func if func is not None else ctx.tree
        hit_line = None
        # json.dump(obj, f) where f came from a bare open(..., 'w')
        if _call_name(node.func) in ("json.dump", "dump"):
            if len(node.args) >= 2 and isinstance(node.args[1], ast.Name):
                if node.args[1].id in self._open_w_names(scope):
                    hit_line = node.lineno
        # f.write(json.dumps(...)) / f.write(name_bound_to_dumps)
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "write"
            and isinstance(node.func.value, ast.Name)
            and len(node.args) == 1
        ):
            if node.func.value.id in self._open_w_names(scope):
                arg = node.args[0]
                dumped = any(_is_json_dumps(n) for n in ast.walk(arg))
                if not dumped:
                    # names in the written expression bound from
                    # json.dumps earlier in the scope
                    arg_names = {n.id for n in ast.walk(arg) if isinstance(n, ast.Name)}
                    dumped = any(
                        isinstance(n, ast.Assign)
                        and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)
                        and n.targets[0].id in arg_names
                        and any(_is_json_dumps(m) for m in ast.walk(n.value))
                        for n in ast.walk(scope)
                    )
                if dumped:
                    hit_line = node.lineno
        if hit_line is None or self._function_is_atomic(scope):
            return
        self.hit(
            ctx.path, hit_line,
            "JSON written through a bare open(..., 'w') — use "
            "ddlpc_tpu_torch.utils.fsio.atomic_write_json (tmp + fsync + rename) "
            "so a crash cannot leave a torn report",
        )


def kernel_symbols(root: str) -> Set[str]:
    """The C entry points that ``kernels/build.py:_SIGNATURES`` declares,
    read from the table's literal (constant keys, and ``**{f"..{w}": ...
    for w in (...)}`` comprehensions over constants) without running the
    module."""
    path = os.path.join(root, PACKAGE, "kernels", "build.py")
    if not os.path.isfile(path):
        return set()
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    names: Set[str] = set()
    for node in tree.body:
        if not (
            isinstance(node, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "_SIGNATURES" for t in node.targets)
            and isinstance(node.value, ast.Dict)
        ):
            continue
        for key, value in zip(node.value.keys, node.value.values):
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                names.add(key.value)
            elif key is None and isinstance(value, ast.DictComp):
                names |= _comprehension_keys(value)
    return names


def _comprehension_keys(comp: ast.DictComp) -> Set[str]:
    """Keys of ``{f"prefix{w}": ... for w in (constants)}``; empty for any
    other shape."""
    if len(comp.generators) != 1 or not isinstance(comp.key, ast.JoinedStr):
        return set()
    gen = comp.generators[0]
    if not isinstance(gen.target, ast.Name) or gen.ifs:
        return set()
    try:
        values = ast.literal_eval(gen.iter)
    except ValueError:
        return set()
    out: Set[str] = set()
    for val in values:
        parts = []
        for p in comp.key.values:
            if isinstance(p, ast.Constant):
                parts.append(str(p.value))
            elif (
                isinstance(p, ast.FormattedValue)
                and isinstance(p.value, ast.Name)
                and p.value.id == gen.target.id
                and p.format_spec is None
            ):
                parts.append(str(val))
            else:
                return set()
        out.add("".join(parts))
    return out


class MetricDocRule(_CollectingRule):
    """metric-doc: every constant ``ddlpc_*`` metric name in code appears
    in docs/OBSERVABILITY.md, and every full metric name in the doc's
    tables exists in code — drift fails in BOTH directions.  Doc names on
    lines marked ``(dynamic)`` (or containing ``<key>`` templates) are
    derived at runtime and exempt from the code-presence direction.  The
    kernels' C entry points (``kernels/build.py:_SIGNATURES``) share the
    prefix and are not metrics."""

    id = "metric-doc"
    doc = (
        "ddlpc_* metric names in code and docs/OBSERVABILITY.md must "
        "match exactly, both directions"
    )

    DOC = os.path.join("docs", "OBSERVABILITY.md")
    _NAME = re.compile(r"^ddlpc_[a-z0-9_]*[a-z0-9]$")
    _DOC_TOKEN = re.compile(r"ddlpc_[a-z0-9_<>]*")
    # names that are identifiers, not metrics, when they appear in prose
    NON_METRIC = frozenset({"ddlpc_tpu", "ddlpc_check", "ddlpc_tpu_torch"})

    def __init__(self):
        super().__init__()
        self._code_names: Dict[str, Tuple[str, int]] = {}

    def visit_Constant(self, node: ast.Constant, ctx: FileContext) -> None:
        v = node.value
        if isinstance(v, str) and self._NAME.match(v) and v not in self.NON_METRIC:
            self._code_names.setdefault(v, (ctx.path, node.lineno))

    def finalize(self, root: str) -> List[Violation]:
        out = super().finalize(root)
        code_names, self._code_names = self._code_names, {}
        symbols = kernel_symbols(root)
        code_names = {k: v for k, v in code_names.items() if k not in symbols}
        doc_path = os.path.join(root, self.DOC)
        if not os.path.exists(doc_path):
            return out  # mini fixture trees without docs skip this rule
        doc_names: Set[str] = set()
        dynamic_prefixes: Set[str] = set()
        with open(doc_path, encoding="utf-8") as f:
            for line in f:
                for tok in self._DOC_TOKEN.findall(line):
                    if "<" in tok or tok.endswith("_"):
                        prefix = tok.split("<")[0]
                        # the bare family prefix would exempt EVERYTHING;
                        # a dynamic prefix must name an actual subfamily
                        if len(prefix) > len("ddlpc_"):
                            dynamic_prefixes.add(prefix)
                    elif self._NAME.match(tok) and tok not in self.NON_METRIC:
                        if "(dynamic)" in line:
                            dynamic_prefixes.add(tok)
                        else:
                            doc_names.add(tok)
        for name, (path, lineno) in sorted(code_names.items()):
            if name not in doc_names:
                out.append(Violation(
                    self.id, path, lineno,
                    f"metric {name!r} is emitted here but missing from {self.DOC} — "
                    f"document it (or it silently disappears from the operator's map)",
                ))
        for name in sorted(doc_names - set(code_names)):
            if any(name.startswith(p) for p in dynamic_prefixes):
                continue
            out.append(Violation(
                self.id, doc_path, 1,
                f"{self.DOC} documents {name!r} but no code emits it — stale docs "
                f"mislead operators; delete the row or mark the line (dynamic)",
            ))
        return out


# What compiles or captures a function in PyTorch.
_COMPILERS = frozenset({
    "torch.compile", "torch.jit.script", "torch.jit.trace", "jit.script", "jit.trace",
    "torch.cuda.make_graphed_callables", "cuda.make_graphed_callables",
})
_CAPTURES = frozenset({"torch.cuda.graph", "cuda.graph"})


def _is_compiler(node: ast.AST) -> bool:
    """``torch.compile`` and kin, bare or called with options, or through
    ``functools.partial``."""
    if _call_name(node) in _COMPILERS:
        return True
    if isinstance(node, ast.Call):
        if _call_name(node.func) in _COMPILERS:
            return True
        return (
            _call_name(node.func).split(".")[-1] == "partial"
            and bool(node.args)
            and _call_name(node.args[0]) in _COMPILERS
        )
    return False


def compiled_regions(tree: ast.Module) -> List[Tuple[ast.AST, str]]:
    """``(node, label)`` of every function a compiler or a CUDA graph takes
    in this file: defs decorated with a compiler, defs and lambdas passed
    to one (by name, resolved in the file), and the bodies of
    ``with torch.cuda.graph(...)`` blocks."""
    defs: Dict[str, ast.AST] = {}
    regions: List[Tuple[ast.AST, str]] = []
    passed: List[str] = []
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[n.name] = n
            if any(_is_compiler(d) for d in n.decorator_list):
                regions.append((n, n.name))
        elif isinstance(n, ast.Call) and _call_name(n.func) in _COMPILERS and n.args:
            target = n.args[0]
            if isinstance(target, ast.Lambda):
                regions.append((target, "<lambda>"))
            elif isinstance(target, ast.Name):
                passed.append(target.id)
        elif isinstance(n, (ast.With, ast.AsyncWith)) and any(
            isinstance(item.context_expr, ast.Call)
            and _call_name(item.context_expr.func) in _CAPTURES
            for item in n.items
        ):
            regions.append((ast.Module(body=n.body, type_ignores=[]), "<cuda graph capture>"))
    regions.extend((defs[name], name) for name in passed if name in defs)
    seen: Set[int] = set()
    out = []
    for node, label in regions:
        if id(node) not in seen:
            seen.add(id(node))
            out.append((node, label))
    return out


class JitHostCallRule(_CollectingRule):
    """jit-host-call: a function that ``torch.compile``, ``torch.jit`` or a
    CUDA graph takes must not call host-side APIs — ``time.*``,
    ``.item()``, ``.cpu()``, ``.tolist()`` or numpy functions.  Each one
    is a graph break and a device→host sync under ``torch.compile``, a
    constant frozen at trace time under ``torch.jit.trace``, and an error
    or a stale value under a CUDA graph's capture and replay."""

    id = "jit-host-call"
    doc = (
        "no time.*/.item()/.cpu()/.tolist()/numpy host calls inside functions "
        "that torch.compile, torch.jit or a CUDA graph takes"
    )

    _NP_OK = frozenset({
        "float32", "float16", "int32", "int8", "int16", "int64", "uint8", "uint16",
        "bool_", "float64", "dtype", "pi", "inf", "newaxis",
    })
    _SYNCS = frozenset({"item", "cpu", "tolist"})

    def end_file(self, ctx: FileContext) -> None:
        for region, label in compiled_regions(ctx.tree):
            for n in ast.walk(region):
                if not isinstance(n, ast.Call):
                    continue
                name = _call_name(n.func)
                msg = None
                if name.startswith("time."):
                    msg = f"{name}() is host time, frozen or a graph break in a compiled function"
                elif (
                    isinstance(n.func, ast.Attribute)
                    and n.func.attr in self._SYNCS
                    and not n.args
                    and not n.keywords
                ):
                    msg = f".{n.func.attr}() forces a device->host sync inside the compiled function"
                elif name.split(".")[0] in ("np", "numpy") and name.split(".")[-1] not in self._NP_OK:
                    msg = (f"numpy host call {name}() inside a compiled function runs at "
                           f"trace time, not per step")
                if msg is not None:
                    self.hit(ctx.path, n.lineno, f"in compiled {label!r}: {msg}")


class CodecFenceRule(_CollectingRule):
    """codec-fence: inside ``parallel/``, the gradient codec runs eagerly,
    never inside a function that ``torch.compile``, ``torch.jit`` or a
    CUDA graph takes.  A compiler would fuse the codec's plain spelling
    into the ops around it (its bits would then depend on the surrounding
    program, what JAX's ``apply_codec_fenced`` fences prevent), and a
    captured launch skips the wrappers' host side on replay (the launch
    counts and the max-abs scratch kept per stream)."""

    id = "codec-fence"
    doc = (
        "codec calls in parallel/ run eagerly, outside torch.compile, "
        "torch.jit and CUDA graph capture"
    )

    _CODEC_FNS = frozenset({
        "fq", "fake_quantize", "fake_quantize_fused", "fake_quantize_plain",
        "encode_to_wire", "decode_from_wire", "encode_with_scale", "decode_with_inv",
    })

    def end_file(self, ctx: FileContext) -> None:
        if os.sep + "parallel" + os.sep not in ctx.path:
            return
        for region, label in compiled_regions(ctx.tree):
            for n in ast.walk(region):
                if isinstance(n, ast.Call):
                    name = _call_name(n.func)
                    if name.split(".")[-1] in self._CODEC_FNS:
                        self.hit(
                            ctx.path, n.lineno,
                            f"codec call {name}(...) inside compiled {label!r} in "
                            f"parallel/ — run the codec eagerly, so its bits cannot "
                            f"depend on the surrounding program",
                        )


def make_rules() -> List[Rule]:
    return [
        JsonlStampRule(),
        AtomicWriteRule(),
        MetricDocRule(),
        JitHostCallRule(),
        CodecFenceRule(),
    ]


ALL_RULE_IDS = [r.id for r in make_rules()] + [
    "import-tier",
    "tier-undeclared",
    "lock-order",
    "guarded-by",
    "bad-suppression",
    "syntax-error",
]
