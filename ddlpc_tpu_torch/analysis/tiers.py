"""Module tier registry and transitive import-graph checker — the port's
copy of ``ddlpc_tpu/analysis/tiers.py``, with the port's three tiers.

Every module under ``ddlpc_tpu_torch`` declares the *import-time*
dependency surface it is allowed, in THIS file, so adding a module forces
an explicit tier decision in review:

- ``stdlib`` — the standard library and same-or-lower-tier
  ``ddlpc_tpu_torch`` modules only.  The telemetry substrate, the
  resilience supervisor and this analyzer live here: importable in any
  thread, any process, with nothing installed.
- ``host`` — third-party host libraries (numpy) allowed; ``torch`` and
  ``triton`` forbidden, TRANSITIVELY.  The fleet's routing tier is here:
  a replica relaunch is milliseconds of Python, not seconds of torch and
  CUDA initialisation.
- ``torch`` — the accelerator tier.

At every tier the roots in :data:`FORBIDDEN_ROOTS` are forbidden: the port
imports nothing of JAX and nothing of the JAX package, and nothing the
card's machine lacks (``tests/test_torch_import.py:FORBIDDEN``).  Roots
are matched by whole dotted component: ``ddlpc_tpu_torch.x`` is the port,
``ddlpc_tpu.x`` is the JAX package.

The checker (:func:`check_tiers`) parses module-level imports with ``ast``
(imports inside functions are deliberate lazy escapes and do not count;
``tests/test_torch_import.py`` pins the runtime truth in fresh
interpreters), adds the implicit parent-package edges (importing ``a.b.c``
executes ``a/__init__`` and ``a/b/__init__`` first), and walks the
closure.  A ``host``-tier module that can reach an ``import torch`` fails
with the full chain, file:line of the offending import included.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

STDLIB, HOST, TORCH = "stdlib", "host", "torch"
_RANK = {STDLIB: 0, HOST: 1, TORCH: 2}

# Forbidden at every tier.
FORBIDDEN_ROOTS = frozenset(
    {"jax", "jaxlib", "flax", "optax", "msgpack", "ddlpc_tpu", "PIL", "ml_dtypes", "imageio"}
)
# Forbidden below the torch tier.
TORCH_ROOTS = frozenset({"torch", "triton"})

PACKAGE = "ddlpc_tpu_torch"

# The one registry.  New modules must be added here explicitly: an
# undeclared module is a violation (rule ``tier-undeclared``), as is a
# declaration for a module that no longer exists.
MODULE_TIERS: Dict[str, str] = {
    "ddlpc_tpu_torch": STDLIB,
    "ddlpc_tpu_torch.config": STDLIB,
    "ddlpc_tpu_torch.convert": TORCH,
    # analysis: the analyzer itself runs without torch; the lock smoke
    # reaches the serve tier and the torch arms lazily, as JAX's does.
    "ddlpc_tpu_torch.analysis": STDLIB,
    "ddlpc_tpu_torch.analysis.check": STDLIB,
    "ddlpc_tpu_torch.analysis.core": STDLIB,
    "ddlpc_tpu_torch.analysis.lock_fixtures": HOST,
    "ddlpc_tpu_torch.analysis.lockcheck": STDLIB,
    "ddlpc_tpu_torch.analysis.rules": STDLIB,
    "ddlpc_tpu_torch.analysis.tiers": STDLIB,
    "ddlpc_tpu_torch.data": STDLIB,
    "ddlpc_tpu_torch.data.datasets": HOST,
    "ddlpc_tpu_torch.data.loader": TORCH,
    "ddlpc_tpu_torch.data.png": HOST,
    "ddlpc_tpu_torch.data.prepare_cityscapes": HOST,
    "ddlpc_tpu_torch.data.prepare_isprs": HOST,
    # kernels: the build and load of the CUDA library is ctypes and nvcc.
    "ddlpc_tpu_torch.kernels": STDLIB,
    "ddlpc_tpu_torch.kernels.build": STDLIB,
    "ddlpc_tpu_torch.models": TORCH,
    "ddlpc_tpu_torch.models.deeplabv3p": TORCH,
    "ddlpc_tpu_torch.models.layers": TORCH,
    "ddlpc_tpu_torch.models.unet": TORCH,
    "ddlpc_tpu_torch.models.unetpp": TORCH,
    # obs: stdlib by charter, except the FLOP model and the comm plan,
    # which read the model and the gradient buffers.
    "ddlpc_tpu_torch.obs": STDLIB,
    "ddlpc_tpu_torch.obs.aggregate": STDLIB,
    "ddlpc_tpu_torch.obs.comm": TORCH,
    "ddlpc_tpu_torch.obs.flops": TORCH,
    "ddlpc_tpu_torch.obs.hbm": STDLIB,
    "ddlpc_tpu_torch.obs.health": STDLIB,
    "ddlpc_tpu_torch.obs.http": STDLIB,
    "ddlpc_tpu_torch.obs.lineage": STDLIB,
    "ddlpc_tpu_torch.obs.merge": STDLIB,
    "ddlpc_tpu_torch.obs.profiling": STDLIB,  # torch reached lazily, per capture
    "ddlpc_tpu_torch.obs.registry": STDLIB,
    "ddlpc_tpu_torch.obs.schema": STDLIB,
    "ddlpc_tpu_torch.obs.tracing": STDLIB,
    "ddlpc_tpu_torch.ops": STDLIB,
    "ddlpc_tpu_torch.ops.cuda_quantize": TORCH,
    "ddlpc_tpu_torch.ops.losses": TORCH,
    "ddlpc_tpu_torch.ops.metrics": TORCH,
    "ddlpc_tpu_torch.ops.philox": TORCH,
    "ddlpc_tpu_torch.ops.quantize": TORCH,
    "ddlpc_tpu_torch.parallel": STDLIB,
    "ddlpc_tpu_torch.parallel.bucketing": STDLIB,
    "ddlpc_tpu_torch.parallel.compressed_allreduce": TORCH,
    "ddlpc_tpu_torch.parallel.grad_sync": TORCH,
    "ddlpc_tpu_torch.parallel.halo": TORCH,
    "ddlpc_tpu_torch.parallel.mesh": TORCH,
    "ddlpc_tpu_torch.parallel.partition": HOST,
    "ddlpc_tpu_torch.parallel.pipeline": TORCH,
    "ddlpc_tpu_torch.parallel.shard_update": TORCH,
    "ddlpc_tpu_torch.parallel.train_step": TORCH,
    "ddlpc_tpu_torch.predict": TORCH,
    # resilience: the supervisor restarts a crashed trainer without
    # importing what crashed it.
    "ddlpc_tpu_torch.resilience": STDLIB,
    "ddlpc_tpu_torch.resilience.chaos": STDLIB,
    "ddlpc_tpu_torch.resilience.protocol": STDLIB,
    "ddlpc_tpu_torch.resilience.supervisor": STDLIB,
    # serve: the batchers are stdlib; the routing and fleet tier is
    # torch-free (numpy allowed, as JAX's HOST tier); the engine and the
    # weight quantizer own torch.
    "ddlpc_tpu_torch.serve": STDLIB,
    "ddlpc_tpu_torch.serve.autoscale": HOST,
    "ddlpc_tpu_torch.serve.batching": STDLIB,
    "ddlpc_tpu_torch.serve.cache": HOST,
    "ddlpc_tpu_torch.serve.cbatch": STDLIB,
    "ddlpc_tpu_torch.serve.engine": TORCH,
    "ddlpc_tpu_torch.serve.fleet": HOST,
    "ddlpc_tpu_torch.serve.metrics": HOST,
    "ddlpc_tpu_torch.serve.quantized": TORCH,
    "ddlpc_tpu_torch.serve.router": HOST,
    "ddlpc_tpu_torch.serve.server": HOST,
    "ddlpc_tpu_torch.train": STDLIB,
    "ddlpc_tpu_torch.train.__main__": STDLIB,  # the trainer is imported in main()
    "ddlpc_tpu_torch.train.async_checkpoint": TORCH,
    "ddlpc_tpu_torch.train.checkpoint": TORCH,
    "ddlpc_tpu_torch.train.hard_task": STDLIB,
    "ddlpc_tpu_torch.train.observability": HOST,
    "ddlpc_tpu_torch.train.optim": TORCH,
    "ddlpc_tpu_torch.train.trainer": TORCH,
    "ddlpc_tpu_torch.train.watchdog": STDLIB,
    "ddlpc_tpu_torch.utils": STDLIB,
    "ddlpc_tpu_torch.utils.flax_msgpack": HOST,
    "ddlpc_tpu_torch.utils.fsio": STDLIB,
    "ddlpc_tpu_torch.utils.native": HOST,
    "ddlpc_tpu_torch.utils.wire": HOST,
}

_STDLIB_NAMES = frozenset(sys.stdlib_module_names) | {"__future__"}


def discover_modules(pkg_dir: str) -> Dict[str, str]:
    """``pkg.x.y`` module name -> file path under ``pkg_dir``."""
    out: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, os.path.dirname(pkg_dir))
            parts = rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out[".".join(parts)] = path
    return out


def _toplevel_imports(tree: ast.Module, module: str, is_pkg: bool) -> List[Tuple[str, int]]:
    """(imported module name, lineno) for every module-level import.

    ``if TYPE_CHECKING:`` blocks never execute — skipped.  ``try:`` /
    ``if:`` bodies at module level DO execute — included.
    """
    out: List[Tuple[str, int]] = []

    def visit_body(body) -> None:
        for node in body:
            if isinstance(node, ast.Import):
                out.extend((a.name, node.lineno) for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = module.split(".")
                    if not is_pkg:
                        base = base[:-1]
                    base = base[: len(base) - (node.level - 1)]
                    prefix = ".".join(base)
                    mod = f"{prefix}.{node.module}" if node.module else prefix
                else:
                    mod = node.module or ""
                if mod:
                    out.append((mod, node.lineno))
                    # `from pkg import name` may bind a SUBMODULE: record
                    # the candidate; the resolver keeps it only if it
                    # exists as a module.
                    for a in node.names:
                        if a.name != "*":
                            out.append((f"{mod}.{a.name}", node.lineno))
            elif isinstance(node, ast.If):
                test = node.test
                is_type_checking = (
                    isinstance(test, ast.Name) and test.id == "TYPE_CHECKING"
                ) or (isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING")
                if not is_type_checking:
                    visit_body(node.body)
                visit_body(node.orelse)
            elif isinstance(node, ast.Try):
                visit_body(node.body)
                for h in node.handlers:
                    visit_body(h.body)
                visit_body(node.orelse)
                visit_body(node.finalbody)

    visit_body(tree.body)
    return out


class ImportGraph:
    """Module-level import edges for one package's source tree; an import
    is internal when its first dotted component is the package's name."""

    def __init__(self, modules: Dict[str, str], package: str):
        self.modules = modules
        # module -> list of (package dep, lineno)
        self.internal: Dict[str, List[Tuple[str, int]]] = {}
        # module -> list of (external root, lineno)
        self.external: Dict[str, List[Tuple[str, int]]] = {}
        for name, path in modules.items():
            with open(path, "r", encoding="utf-8") as f:
                try:
                    tree = ast.parse(f.read(), filename=path)
                except SyntaxError:
                    continue  # the AST rules report syntax errors
            is_pkg = os.path.basename(path) == "__init__.py"
            ints: List[Tuple[str, int]] = []
            exts: List[Tuple[str, int]] = []
            # implicit parent-package edges: importing a.b.c runs a and
            # a.b first
            parent = name.rsplit(".", 1)[0]
            if parent != name:
                ints.append((parent, 0))
            for mod, lineno in _toplevel_imports(tree, name, is_pkg):
                root = mod.split(".")[0]
                if root == package:
                    target = mod
                    while target and target not in modules:
                        target = target.rsplit(".", 1)[0] if "." in target else ""
                    if target and target != name:
                        ints.append((target, lineno))
                else:
                    exts.append((root, lineno))
            self.internal[name] = ints
            self.external[name] = exts

    def reach(
        self, start: str, forbidden: Callable[[str], bool]
    ) -> Optional[Tuple[List[str], str, int]]:
        """BFS: can ``start`` reach a forbidden external root at import
        time?  Returns (module chain, root, lineno) or None."""
        seen = {start}
        queue: List[Tuple[str, List[str]]] = [(start, [start])]
        while queue:
            mod, path = queue.pop(0)
            for root, lineno in self.external.get(mod, ()):
                if forbidden(root):
                    return path, root, lineno
            for dep, _ in self.internal.get(mod, ()):
                if dep not in seen:
                    seen.add(dep)
                    queue.append((dep, path + [dep]))
        return None


def forbidden_for(tier: str) -> Callable[[str], bool]:
    """The import roots a module of ``tier`` may not reach."""
    if tier == TORCH:
        return lambda root: root in FORBIDDEN_ROOTS
    if tier == HOST:
        return lambda root: root in FORBIDDEN_ROOTS or root in TORCH_ROOTS
    return lambda root: root not in _STDLIB_NAMES


def check_tiers(
    pkg_dir: str, registry: Optional[Dict[str, str]] = None
) -> List[Tuple[str, str, int, str]]:
    """All tier violations for the package at ``pkg_dir`` (its name is the
    directory's).  Returns ``(rule_id, path, line, message)`` tuples; empty
    means every declaration is proven."""
    registry = MODULE_TIERS if registry is None else registry
    modules = discover_modules(pkg_dir)
    out: List[Tuple[str, str, int, str]] = []
    for name in sorted(set(modules) - set(registry)):
        out.append((
            "tier-undeclared", modules[name], 1,
            f"module {name} is not declared in analysis/tiers.py:MODULE_TIERS — "
            f"new modules must opt into a tier explicitly",
        ))
    for name in sorted(set(registry) - set(modules)):
        out.append((
            "tier-undeclared", os.path.join(pkg_dir, "__init__.py"), 1,
            f"MODULE_TIERS declares {name} but no such module exists — remove "
            f"the stale entry",
        ))
    graph = ImportGraph(modules, os.path.basename(os.path.normpath(pkg_dir)))
    for name in sorted(set(modules) & set(registry)):
        tier = registry[name]
        hit = graph.reach(name, forbidden_for(tier))
        if hit is not None:
            chain, root, lineno = hit
            offender = chain[-1]
            out.append((
                "import-tier", graph.modules[offender], lineno,
                f"{name} is tier '{tier}' but reaches 'import {root}' via "
                f"{' -> '.join(chain)} (module-level import in {offender})",
            ))
        # A declared tier must also bound the declared tiers of direct
        # package deps: a stdlib module leaning on a host module fails
        # even before the host module grows a forbidden import.
        for dep, lineno in graph.internal.get(name, ()):
            dep_tier = registry.get(dep)
            if dep_tier is not None and _RANK[dep_tier] > _RANK[tier]:
                out.append((
                    "import-tier", graph.modules[name], lineno or 1,
                    f"{name} (tier '{tier}') imports {dep} (tier '{dep_tier}') at "
                    f"module level — a module may only import its own tier or below",
                ))
    return out
