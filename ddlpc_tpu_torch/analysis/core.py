"""AST rule engine: shared visitor, suppressions, analysis orchestration —
the port's copy of ``ddlpc_tpu/analysis/core.py``.

One parse per file; every rule sees every node through a single walk
(rules implement ``visit_<NodeType>`` methods, cross-file rules aggregate
in ``finalize``).  Suppression is per line::

    f.write(json.dumps(rec) + "\\n")  # ddlpc-check: disable=jsonl-stamp pass-through of already-stamped records

A suppression comment without a written reason is itself a violation
(``bad-suppression``): every exemption carries its argument in the diff.
Suppressed violations are counted and reported in the summary, never
silently dropped.

The surface is the port's package, ``ddlpc_tpu_torch/`` (recursive), and
``chip_smoke.py``, the port's driver on the card, as ``scripts/`` is the
JAX package's.
"""

from __future__ import annotations

import ast
import io
import os
import time
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ddlpc_tpu_torch.analysis import tiers as tiers_mod

SUPPRESS_MARK = "ddlpc-check:"
PACKAGE = tiers_mod.PACKAGE
DRIVER = "chip_smoke.py"


@dataclass
class Violation:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"


@dataclass
class FileContext:
    """Everything a rule may need about the file being visited."""

    path: str
    tree: ast.Module
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)

    def enclosing_function(self, node: ast.AST):
        """Nearest enclosing FunctionDef/AsyncFunctionDef, or None."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None


class Rule:
    """Base: one invariant, one id, one doc line."""

    id: str = ""
    doc: str = ""

    def end_file(self, ctx: FileContext) -> None:
        pass

    def finalize(self, root: str) -> List[Violation]:
        return []


def _parse_suppressions(src: str, path: str) -> Tuple[Dict[int, Dict[str, str]], List[Violation]]:
    """line -> {rule_id: reason}; malformed suppressions come back as
    violations.  A comment on its own line also covers the next line."""
    per_line: Dict[int, Dict[str, str]] = {}
    bad: List[Violation] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        comments = [
            (t.start[0], t.string, t.line)
            for t in tokens
            if t.type == tokenize.COMMENT and SUPPRESS_MARK in t.string
        ]
    except (tokenize.TokenError, SyntaxError):
        # IndentationError (a SyntaxError) also escapes tokenize; fall
        # through with no suppressions — ast.parse reports the file as a
        # syntax-error violation on the normal path.
        return per_line, bad
    for lineno, text, logical in comments:
        body = text.split(SUPPRESS_MARK, 1)[1].strip()
        if not body.startswith("disable="):
            bad.append(Violation(
                "bad-suppression", path, lineno,
                f"unrecognized ddlpc-check directive {text.strip()!r} "
                f"(expected '# ddlpc-check: disable=RULE reason')",
            ))
            continue
        parts = body[len("disable="):].split(None, 1)
        rules = [r for r in parts[0].split(",") if r]
        reason = parts[1].strip() if len(parts) > 1 else ""
        if not reason:
            bad.append(Violation(
                "bad-suppression", path, lineno,
                "suppression without a reason — write WHY the rule does not apply here",
            ))
            continue
        targets = [lineno]
        if logical.strip().startswith("#"):
            targets.append(lineno + 1)  # standalone comment covers next line
        for ln in targets:
            slot = per_line.setdefault(ln, {})
            for r in rules:
                slot[r] = reason
    return per_line, bad


def collect_files(root: str) -> List[str]:
    """The analysis surface: ``ddlpc_tpu_torch/`` (recursive) and
    ``chip_smoke.py``."""
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, PACKAGE)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in filenames if f.endswith(".py"))
    driver = os.path.join(root, DRIVER)
    if os.path.isfile(driver):
        out.append(driver)
    return sorted(out)


@dataclass
class AnalysisResult:
    violations: List[Violation]
    files_scanned: int
    duration_s: float
    rules_run: List[str]

    @property
    def unsuppressed(self) -> List[Violation]:
        return [v for v in self.violations if not v.suppressed]

    @property
    def suppressed(self) -> List[Violation]:
        return [v for v in self.violations if v.suppressed]


class _Dispatch(ast.NodeVisitor):
    def __init__(self, rules, ctx: FileContext):
        self.handlers: Dict[str, list] = {}
        for r in rules:
            for attr in dir(r):
                if attr.startswith("visit_") and attr != "visit_":
                    self.handlers.setdefault(attr[6:], []).append(getattr(r, attr))
        self.ctx = ctx

    def generic_visit(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            self.ctx.parents[child] = node
        for h in self.handlers.get(type(node).__name__, ()):
            h(node, self.ctx)
        super().generic_visit(node)


def run_analysis(root: str, rule_ids: Optional[Set[str]] = None) -> AnalysisResult:
    """Run the import-graph checker and the AST rules over ``root``.

    ``rule_ids`` filters to a subset (tier rules included only when named
    or when the filter is absent).  Suppressions are applied here so every
    caller — CLI, tests — sees identical semantics.
    """
    from ddlpc_tpu_torch.analysis.rules import make_rules

    t0 = time.perf_counter()
    violations: List[Violation] = []
    rules = [r for r in make_rules() if rule_ids is None or r.id in rule_ids]
    rules_run = [r.id for r in rules]

    pkg_dir = os.path.join(root, PACKAGE)
    tier_wanted = rule_ids is None or bool({"import-tier", "tier-undeclared"} & rule_ids)
    if tier_wanted and os.path.isdir(pkg_dir):
        for rule_id, path, line, msg in tiers_mod.check_tiers(pkg_dir):
            violations.append(Violation(rule_id, path, line, msg))
        rules_run = ["import-tier", "tier-undeclared"] + rules_run

    files = collect_files(root)
    suppress_maps: Dict[str, Dict[int, Dict[str, str]]] = {}
    for path in files:
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        sup, bad = _parse_suppressions(src, path)
        suppress_maps[path] = sup
        violations.extend(bad)
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            violations.append(Violation(
                "syntax-error", path, e.lineno or 1, f"file does not parse: {e.msg}"
            ))
            continue
        ctx = FileContext(path=path, tree=tree)
        _Dispatch(rules, ctx).visit(tree)
        for r in rules:
            r.end_file(ctx)
    for r in rules:
        violations.extend(r.finalize(root))

    # apply suppressions (tier violations can be suppressed too: the
    # comment lives on the flagged import line)
    for v in violations:
        reason = suppress_maps.get(v.path, {}).get(v.line, {}).get(v.rule)
        if reason is not None:
            v.suppressed = True
            v.reason = reason
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return AnalysisResult(
        violations=violations,
        files_scanned=len(files),
        duration_s=time.perf_counter() - t0,
        rules_run=rules_run,
    )
