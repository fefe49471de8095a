"""The port's invariant checker (``ddlpc_tpu_torch/analysis``) held against
the JAX package's (``ddlpc_tpu/analysis``) on the CPU.

- the shared rules (``jsonl-stamp``, ``atomic-write``, ``metric-doc`` and
  ``bad-suppression``) give the same ``(rule, line)`` set as JAX's on the
  same fixture files: those of ``tests/test_analysis.py``;
- the port forms of ``jit-host-call`` and ``codec-fence`` flag a
  ``torch.compile``d, ``torch.jit``ted or CUDA-graph-captured function
  and pass the eager form;
- the import-tier checker: the tiers, the forbidden roots matched by
  whole dotted component, the table against ``test_torch_import.FLEET_TIER``;
- the CLI: the whole tree exits 0 with zero suppressions inside 30 s and
  its ``--out`` stream lints; each injected fault exits 1 naming its rule
  and place;
- the repairs the checker forced: ``ops.json`` and ``chip_smoke.py``'s rank
  results are written atomically.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ddlpc_tpu.analysis.core import run_analysis as jax_run_analysis  # noqa: E402
from ddlpc_tpu_torch.analysis import check  # noqa: E402
from ddlpc_tpu_torch.analysis.core import run_analysis  # noqa: E402
from ddlpc_tpu_torch.analysis.rules import kernel_symbols  # noqa: E402
from ddlpc_tpu_torch.analysis.tiers import (  # noqa: E402
    HOST, MODULE_TIERS, STDLIB, TORCH, check_tiers,
)
from ddlpc_tpu_torch.obs import profiling  # noqa: E402
from ddlpc_tpu_torch.obs.schema import check_record  # noqa: E402
from test_torch_import import FLEET_TIER, PORT_MODULES  # noqa: E402
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

# The fixtures of tests/test_analysis.py's rule units, each with the docs
# file it runs against (None: the tree has none).
METRIC_DOCS = (
    "| `ddlpc_documented_total` | counter |\n"
    "| `ddlpc_stale_gauge` | gauge |\n"
    "| `ddlpc_derived_<key>` | gauge |\n"
    "| `ddlpc_dynamic_example` | gauge | (dynamic) |\n"
)
SHARED_FIXTURES = {
    "jsonl_stamp_bare": ("""
        import json
        def emit(f, rec):
            f.write(json.dumps(rec) + "\\n")
        """, None),
    "jsonl_stamp_stamped_forms": ("""
        import json
        from ddlpc_tpu.obs.schema import stamp
        def a(f, rec):
            f.write(json.dumps(stamp(rec)) + "\\n")
        def b(f, rec):
            rec.setdefault("schema", 1)
            f.write(json.dumps(rec) + "\\n")
        def c(f):
            f.write(json.dumps({"schema": 1, "x": 2}) + "\\n")
        def d(fin, fout, tag):
            for line in fin:
                fout.write(json.dumps(dict(json.loads(line), t=tag)) + "\\n")
        def e(f, rec):
            f.write(json.dumps(rec, indent=2))  # report, not a stream
        """, None),
    "atomic_write": ("""
        import json, os, tempfile
        def bad(path, rec):
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
        def bad2(path, rec):
            body = json.dumps(rec, indent=2)
            with open(path, "w") as f:
                f.write(body)
        def good(path, rec):
            fd, tmp = tempfile.mkstemp(dir=".")
            with os.fdopen(fd, "w") as f:
                json.dump(rec, f)
                os.fsync(f.fileno())
            os.replace(tmp, path)
        """, None),
    "metric_doc_both_directions": ("""
        NAME = "ddlpc_undocumented_total"
        OK = "ddlpc_documented_total"
        """, METRIC_DOCS),
    "suppression_reason": ("""
        import json
        def a(f, rec):
            f.write(json.dumps(rec) + "\\n")  # ddlpc-check: disable=jsonl-stamp records stamped by caller
        def b(f, rec):
            f.write(json.dumps(rec) + "\\n")  # ddlpc-check: disable=jsonl-stamp
        """, None),
}


def _tree(root, files: dict, docs=None) -> str:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    if docs is not None:
        d = root / "docs" / "OBSERVABILITY.md"
        d.parent.mkdir(parents=True, exist_ok=True)
        d.write_text(docs)
    return str(root)


def _found(result) -> set:
    return {(v.rule, v.line, v.suppressed, os.path.basename(v.path) == "OBSERVABILITY.md")
            for v in result.violations}


@pytest.mark.parametrize("name", sorted(SHARED_FIXTURES))
def test_shared_rules_flag_what_jax_flags(tmp_path, name):
    """The same source as a JAX script and as the port's driver: the same
    (rule, line) set, suppressions and docs-side hits included."""
    src, docs = SHARED_FIXTURES[name]
    jax_root = _tree(tmp_path / "jax", {"scripts/fixture.py": src}, docs)
    port_root = _tree(tmp_path / "port", {"chip_smoke.py": src}, docs)
    want = _found(jax_run_analysis(jax_root))
    got = _found(run_analysis(port_root))
    assert got == want
    if name != "jsonl_stamp_stamped_forms":
        assert want  # each of the others flags something


COMPILED = """
    import time
    import numpy as np
    import torch
    from functools import partial

    @torch.compile
    def bad_clock(x):
        return x + time.time()

    @torch.compile(mode="reduce-overhead")
    def bad_item(x):
        return float(x.item())

    @partial(torch.compile, fullgraph=True)
    def bad_tolist(x):
        return x.tolist()

    @torch.jit.script
    def bad_cpu(x):
        return x.cpu()

    def stepper(x):
        return np.asarray(x) + 1

    stepped = torch.compile(stepper)
    traced = torch.jit.trace(lambda x: x.item(), (torch.ones(1),))

    def capture(g, x):
        with torch.cuda.graph(g):
            y = x * 2
            t = time.perf_counter()
        return y, t

    def eager(x):
        return time.time(), np.asarray(x), x.item(), x.cpu(), x.tolist()

    @torch.compile
    def ok_dtype(x):
        return x.to(torch.float32) + np.float32(1)
    """


def test_jit_host_call_flags_compiled_and_captured_functions(tmp_path):
    root = _tree(tmp_path, {"chip_smoke.py": COMPILED})
    res = run_analysis(root, rule_ids={"jit-host-call"})
    got = sorted((v.line, v.message.split(":")[0]) for v in res.unsuppressed)
    assert got == [
        (9, "in compiled 'bad_clock'"),
        (13, "in compiled 'bad_item'"),
        (17, "in compiled 'bad_tolist'"),
        (21, "in compiled 'bad_cpu'"),
        (24, "in compiled 'stepper'"),
        (27, "in compiled '<lambda>'"),
        (32, "in compiled '<cuda graph capture>'"),
    ], [v.format() for v in res.unsuppressed]
    assert {v.rule for v in res.unsuppressed} == {"jit-host-call"}


CODEC = """
    import torch
    from ddlpc_tpu_torch.ops import cuda_quantize as cq

    def eager_sync(flat, cfg, fq):
        return fq(flat, cfg), cq.decode_from_wire(flat, flat)

    @torch.compile
    def fused_sync(flat, cfg, fq):
        return fq(flat, cfg)

    def captured(g, q, inv):
        with torch.cuda.graph(g):
            out = cq.decode_from_wire(q, inv)
        return out
    """


def test_codec_fence_flags_a_compiled_codec_call_in_parallel_only(tmp_path):
    root = _tree(tmp_path, {"ddlpc_tpu_torch/parallel/newsync.py": CODEC,
                            "ddlpc_tpu_torch/serve/elsewhere.py": CODEC})
    res = run_analysis(root, rule_ids={"codec-fence"})
    assert [(os.path.basename(v.path), v.line) for v in res.unsuppressed] == [
        ("newsync.py", 10), ("newsync.py", 14)
    ], [v.format() for v in res.unsuppressed]


def test_the_kernels_c_entries_are_read_from_the_build_table():
    from ddlpc_tpu_torch.kernels.build import _SIGNATURES

    assert kernel_symbols(REPO) == set(_SIGNATURES)
    assert len(_SIGNATURES) == 16


def test_metric_doc_takes_no_c_entry_for_a_metric(tmp_path):
    """A ``ddlpc_*`` constant named in ``_SIGNATURES`` is a symbol; the
    same name elsewhere without the table is an undocumented metric."""
    build = textwrap.dedent("""
        _P = None
        _SIGNATURES = {
            "ddlpc_absmax": (_P,),
            **{f"ddlpc_encode_sr_{w}": (_P,) for w in ("i8", "f16")},
        }
        """)
    user = 'NAMES = ("ddlpc_absmax", "ddlpc_encode_sr_f16", "ddlpc_documented_total")\n'
    docs = "| `ddlpc_documented_total` | counter |\n"
    with_table = _tree(tmp_path / "a", {"ddlpc_tpu_torch/kernels/build.py": build,
                                        "chip_smoke.py": user}, docs)
    assert run_analysis(with_table, rule_ids={"metric-doc"}).unsuppressed == []
    without = _tree(tmp_path / "b", {"chip_smoke.py": user}, docs)
    flagged = run_analysis(without, rule_ids={"metric-doc"}).unsuppressed
    assert sorted(v.message.split("'")[1] for v in flagged) == [
        "ddlpc_absmax", "ddlpc_encode_sr_f16"]


def test_tier_checker_units(tmp_path):
    """Host reaching torch through a chain, a forbidden root at the torch
    tier, and the ``ddlpc_tpu`` / ``ddlpc_tpu_torch`` prefix: roots are
    whole dotted components."""
    pkg = tmp_path / "ddlpc_tpu_torch"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "sub" / "__init__.py").write_text("")
    (pkg / "sub" / "deep.py").write_text("import torch\n")
    (pkg / "hosty.py").write_text("import numpy\nfrom ddlpc_tpu_torch.sub import deep\n")
    (pkg / "own.py").write_text("import ddlpc_tpu_torch.sub\nfrom ddlpc_tpu_torch import hosty\n")
    (pkg / "jaxpkg.py").write_text("from ddlpc_tpu.ops import quantize\n")
    (pkg / "rogue.py").write_text("")
    registry = {
        "ddlpc_tpu_torch": STDLIB,
        "ddlpc_tpu_torch.sub": TORCH,
        "ddlpc_tpu_torch.sub.deep": TORCH,
        "ddlpc_tpu_torch.hosty": HOST,
        "ddlpc_tpu_torch.own": TORCH,
        "ddlpc_tpu_torch.jaxpkg": TORCH,
    }
    out = check_tiers(str(pkg), registry=registry)
    assert [(r, os.path.basename(p)) for r, p, _l, _m in out if r == "tier-undeclared"] == [
        ("tier-undeclared", "rogue.py")]
    tier = sorted((os.path.basename(p), line, m) for r, p, line, m in out if r == "import-tier")
    assert [(p, line) for p, line, _ in tier] == [
        ("deep.py", 1), ("hosty.py", 2), ("hosty.py", 2), ("jaxpkg.py", 1)], tier
    assert "reaches 'import torch' via ddlpc_tpu_torch.hosty -> ddlpc_tpu_torch.sub.deep" in tier[0][2]
    assert "imports ddlpc_tpu_torch.sub (tier 'torch')" in tier[1][2]
    assert "imports ddlpc_tpu_torch.sub.deep (tier 'torch')" in tier[2][2]
    assert "reaches 'import ddlpc_tpu' via ddlpc_tpu_torch.jaxpkg" in tier[3][2]


def test_every_port_module_is_declared_and_the_fleet_tier_agrees():
    """The static table against the subprocess pins of
    ``test_torch_import.py``: a module that must load no numpy is
    ``stdlib``, one that must load no torch ``host``."""
    for module, forbidden in FLEET_TIER.items():
        assert MODULE_TIERS[module] == (STDLIB if "numpy" in forbidden else HOST), module
    assert set(PORT_MODULES) <= set(MODULE_TIERS)
    assert check_tiers(os.path.join(REPO, "ddlpc_tpu_torch")) == []


def test_cli_whole_tree_is_clean_and_its_stream_lints(tmp_path, capsys):
    out = tmp_path / "analysis.jsonl"
    rc = check.main(["--out", str(out)])
    printed = capsys.readouterr()
    assert rc == 0, printed.out + printed.err
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert all(check_record(r) == [] for r in recs)
    summary = recs[-1]
    assert summary["rule"] == "summary" and summary["kind"] == "analysis"
    assert summary["violations"] == 0
    assert summary["suppressed"] == 0  # zero exemptions, as JAX's tree
    assert summary["files_scanned"] > 80
    assert summary["duration_s"] < 30.0
    # the JAX package's stream lint reads it too
    spec = importlib.util.spec_from_file_location(
        "check_metrics_schema", os.path.join(REPO, "scripts", "check_metrics_schema.py"))
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    kinds: dict = {}
    assert lint.lint_file(str(out), kind_counts=kinds) == []
    assert kinds == {"analysis": len(recs)}


def test_cli_usage_errors(capsys):
    assert check.main(["--rules", "no-such-rule"]) == 2
    assert check.main(["--programs"]) == 2
    assert "A8.3" in capsys.readouterr().err
    assert check.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert "jit-host-call" in listed and "codec-fence" in listed


def _copy_port(tmp_path):
    dst = tmp_path / "tree"
    shutil.copytree(os.path.join(REPO, "ddlpc_tpu_torch"), dst / "ddlpc_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    (dst / "docs").mkdir()
    shutil.copy(os.path.join(REPO, "docs", "OBSERVABILITY.md"), dst / "docs")
    return dst


def _inject_import(module: str):
    def inject(tmp_path):
        dst = _copy_port(tmp_path)
        router = dst / "ddlpc_tpu_torch" / "serve" / "router.py"
        router.write_text(f"import {module}\n" + router.read_text())
        return str(dst), ["--rules", "import-tier,tier-undeclared"]
    return inject


def _mini(files: dict, rule: str):
    def inject(tmp_path):
        return _tree(tmp_path, files), ["--rules", rule]
    return inject


def _undocumented_metric(tmp_path):
    dst = _copy_port(tmp_path)
    router = dst / "ddlpc_tpu_torch" / "serve" / "router.py"
    router.write_text(router.read_text().replace(
        '"ddlpc_router_drains_total"', '"ddlpc_router_bogus_total"', 1))
    return str(dst), ["--rules", "metric-doc"]


def _inversion(tmp_path):
    return REPO, ["--rules", "lock-order", "--lockcheck-fixture",
                  "ddlpc_tpu_torch.analysis.lock_fixtures:inversion_demo"]


INJECTED = {
    "jax_in_router": (_inject_import("jax"), "[import-tier]",
                      ("router.py:1", "'import jax'")),
    "torch_in_router": (_inject_import("torch"), "[import-tier]",
                        ("router.py:1", "'import torch'", "tier 'host'")),
    "unstamped_jsonl": (_mini({"chip_smoke.py": SHARED_FIXTURES["jsonl_stamp_bare"][0]},
                              "jsonl-stamp"), "[jsonl-stamp]", ("chip_smoke.py:4",)),
    "bare_json_open": (_mini({"ddlpc_tpu_torch/obs/report.py": SHARED_FIXTURES["atomic_write"][0]},
                             "atomic-write"), "[atomic-write]", ("report.py:5", "report.py:9")),
    "undocumented_metric": (_undocumented_metric, "[metric-doc]",
                            ("ddlpc_router_bogus_total", "router.py", "ddlpc_router_drains_total")),
    "host_call_in_compiled": (_mini({"chip_smoke.py": COMPILED}, "jit-host-call"),
                              "[jit-host-call]", ("chip_smoke.py:9", "bad_clock")),
    "lock_inversion": (_inversion, "[lock-order]",
                       ("demo.A -> demo.B", "demo.B -> demo.A", "lock_fixtures.py:")),
}


@pytest.mark.parametrize("case", sorted(INJECTED))
def test_injected_fault_exits_one_naming_rule_and_place(tmp_path, capsys, case):
    make, rule, places = INJECTED[case]
    root, args = make(tmp_path)
    rc = check.main(["--root", root, *args])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert rule in out
    for place in places:
        assert place in out, out


class _Event:
    def __init__(self, key):
        self.key = key
        self.self_cpu_time_total = 1.0
        self.device_time_total = 2.0
        self.count = 1


class _Profiler:
    """What ``_stop_profiler`` reads of a ``torch.profiler`` capture."""

    def __init__(self, keys):
        self.keys = keys
        self.traced = []

    def stop(self):
        pass

    def key_averages(self):
        return [_Event(k) for k in self.keys]

    def export_chrome_trace(self, path):
        self.traced.append(path)


def test_ops_json_is_written_whole_or_not_at_all(tmp_path):
    """A capture's per-op table goes to ``ops.json`` by tmp + rename: an op
    the encoder refuses leaves the previous capture's file whole, never a
    torn one."""
    profiling._stop_profiler(_Profiler(["aten::add", "aten::mul"]), str(tmp_path))
    path = tmp_path / profiling.OPS_FILE
    first = path.read_text()
    assert [o["op"] for o in json.loads(first)] == ["aten::add", "aten::mul"]
    with pytest.raises(TypeError):
        profiling._stop_profiler(_Profiler(["aten::add", object()]), str(tmp_path))
    assert path.read_text() == first
    assert sorted(os.listdir(tmp_path)) == [profiling.OPS_FILE]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_rank_result_is_written_whole_or_not_at_all(tmp_path, chip_smoke):
    """A rank process's result file, which its parent reads after the
    world ends: a result the encoder refuses leaves no file, and a file
    already there whole."""
    path = chip_smoke.write_rank_result(str(tmp_path), 3, {"losses": [1.5, 1.25]})
    assert json.loads(open(path).read()) == {"losses": [1.5, 1.25]}
    with pytest.raises(TypeError):
        chip_smoke.write_rank_result(str(tmp_path), 4, {"losses": [1.0], "state": object()})
    with pytest.raises(TypeError):
        chip_smoke.write_rank_result(str(tmp_path), 3, {"losses": [1.0], "state": object()})
    assert sorted(os.listdir(tmp_path)) == ["rank3.json"]
    assert json.loads(open(path).read()) == {"losses": [1.5, 1.25]}


def test_chip_smoke_looks_for_the_codec_kernels_by_their_cuda_names(chip_smoke):
    """The profiler names the codec's CUDA kernels; the C entries are host
    functions and never appear among its ops."""
    assert not any(name.startswith("ddlpc_") for name in chip_smoke.CODEC_KERNEL_NAMES)
    kernels = ("encode_kernel", "encode_sr_kernel", "encode_noise_kernel", "decode_kernel",
               "fake_quantize_kernel", "fake_quantize_sr_kernel", "fake_quantize_noise_kernel",
               "absmax_kernel")
    assert all(any(k in name for k in chip_smoke.CODEC_KERNEL_NAMES) for name in kernels)
