"""ddlpc-check for the port: the invariant analyzer over ``ddlpc_tpu_torch/``
and ``chip_smoke.py`` — the port's counterpart of ``scripts/ddlpc_check.py``.

One command proves the contracts the tests cannot see from outputs alone:

- **import tiers** — every module declared in ``analysis/tiers.py:MODULE_TIERS``
  and the declaration proven transitively: nothing of JAX or the JAX
  package anywhere, the fleet and routing tier torch-free;
- **AST rules** — schema-stamped JSONL emits, metric-name ↔
  docs/OBSERVABILITY.md drift (both directions), tmp+rename report writes,
  no host calls inside functions that ``torch.compile``, ``torch.jit`` or a
  CUDA graph takes, no codec call in ``parallel/`` inside one;
- **lock order** — the instrumented-lock smoke (``analysis/lock_fixtures.py``)
  runs the threaded hot spots and fails on acquisition-graph cycles or
  ``# guarded-by:`` violations;
- **sanitizers** (``--sanitize``) — the host batch kernel's self-test
  (``kernels/host/batch.cc``, ``DWB_TEST_MAIN``) built by ``g++`` under
  ASan and UBSan into ``kernels/build/`` and run with ``--stress``; the
  TSan arm probes the toolchain first and skips with a logged reason.

Usage:
    python -m ddlpc_tpu_torch.analysis.check                     # whole tree
    python -m ddlpc_tpu_torch.analysis.check --rules metric-doc  # one rule
    python -m ddlpc_tpu_torch.analysis.check --out runs/analysis.jsonl
    python -m ddlpc_tpu_torch.analysis.check --list-rules
    python -m ddlpc_tpu_torch.analysis.check --sanitize

Violations print as ``path:line: [rule] message``; suppressed ones are
counted in the summary.  The ``--out`` stream is flat ``kind="analysis"``
records, stamped by the port's ``obs/schema.py`` and written atomically.
``--programs`` is the program auditor (``analysis/program.py``: JAX's 28
arms and 36 programs, one real step each in a world of 8 gloo ranks, held
to ``comm-closed-form``, ``dtype-flow``, ``placement``, ``codec-calls``
and ``stage-boundary``, and to the committed baseline
``docs/port_analysis/program_baseline.json``)::

    python -m ddlpc_tpu_torch.analysis.check --programs --device cpu
    python -m ddlpc_tpu_torch.analysis.check --programs            # ranks on cuda:0
    python -m ddlpc_tpu_torch.analysis.check --programs --arms int8_zero2,pipe2_none
    python -m ddlpc_tpu_torch.analysis.check --programs --inject fp32-widen   # must exit 1
    python -m ddlpc_tpu_torch.analysis.check --programs --out runs/programs.jsonl
    python -m ddlpc_tpu_torch.analysis.check --programs --device cpu --update-baseline

Its violations print as ``program_audit: VIOLATION <program>: [<contract>]
<message>``, a structural difference from the baseline as ``[census-drift]``
(the baseline's age or torch version only warn); ``--update-baseline``
rewrites the audited programs' entries instead of comparing.  ``--out``
writes flat ``kind="program"`` records ending with a ``record="summary"``
one.  ``--inject drop-fence`` has no eager counterpart and exits 2.

Exit status: 0 clean, 1 unsuppressed violations, 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

from ddlpc_tpu_torch.analysis import lockcheck
from ddlpc_tpu_torch.analysis.core import PACKAGE, Violation, run_analysis
from ddlpc_tpu_torch.analysis.rules import ALL_RULE_IDS, make_rules
from ddlpc_tpu_torch.obs.schema import check_record, stamp
from ddlpc_tpu_torch.utils.fsio import atomic_write_json, atomic_write_text

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXTRA_RULES = ("import-tier", "tier-undeclared", "lock-order", "guarded-by", "bad-suppression")

# The host sanitizer arms over kernels/host/batch.cc (csrc/Makefile's).
SAN_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer", "-std=c++17", "-Wall", "-Wextra")
SANITIZERS = {
    "asan": ("-fsanitize=address",),
    "ubsan": ("-fsanitize=undefined", "-fno-sanitize-recover=all"),
    "tsan": ("-fsanitize=thread",),
}


def _run_lock_fixture(spec: str) -> List[Violation]:
    """Import ``module:callable``, run it under lockcheck, return
    lock-order / guarded-by violations as analyzer violations.  The
    previous enabled state is restored: tests drive this in-process."""
    mod_name, _, fn_name = spec.partition(":")
    was_enabled = lockcheck.enabled()
    lockcheck.enable()
    lockcheck.reset()
    try:
        getattr(importlib.import_module(mod_name), fn_name)()
        return [
            Violation("guarded-by" if v.startswith("guarded-by:") else "lock-order", spec, 0, v)
            for v in lockcheck.violations()
        ]
    finally:
        if not was_enabled:
            lockcheck.disable()
        lockcheck.reset()


def sanitize(root: str, arms=tuple(SANITIZERS), log: Callable[[str], None] = print) -> List[Violation]:
    """Build ``kernels/host/batch.cc``'s self-test under each sanitizer arm
    into ``kernels/build/`` and run it with ``--stress``; an arm whose
    build or run fails, or whose run does not print ``batch_check stress
    OK``, is a violation.  The TSan arm first builds and runs an empty
    program with ``-fsanitize=thread`` and is skipped, with the reason
    logged, where that fails."""
    src = os.path.join(root, PACKAGE, "kernels", "host", "batch.cc")
    build_dir = os.path.join(root, PACKAGE, "kernels", "build")
    os.makedirs(build_dir, exist_ok=True)
    out: List[Violation] = []
    for arm in arms:
        flags = SANITIZERS[arm]
        exe = os.path.join(build_dir, f"batch_check_{arm}.{os.getpid()}")
        try:
            if arm == "tsan" and not _tsan_works(build_dir):
                log("tsan skipped: g++ cannot build and run -fsanitize=thread on this platform")
                continue
            r = subprocess.run(["g++", *SAN_FLAGS, *flags, "-DDWB_TEST_MAIN", src, "-o", exe,
                                "-lpthread"], capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                out.append(Violation("sanitize", src, 0, f"{arm} build failed: {r.stderr[-2000:]}"))
                continue
            r = subprocess.run([exe, "--stress"], capture_output=True, text=True, timeout=300)
        finally:
            if os.path.exists(exe):
                os.remove(exe)
        if r.returncode != 0 or "batch_check stress OK" not in r.stdout:
            out.append(Violation("sanitize", src, 0, f"{arm} run failed ({r.returncode}): "
                                 f"{(r.stdout + r.stderr)[-2000:]}"))
        else:
            log(f"{arm}: {'; '.join(r.stdout.strip().splitlines())}")
    return out


def _tsan_works(build_dir: str) -> bool:
    probe = os.path.join(build_dir, f"tsan_probe.{os.getpid()}")
    try:
        r = subprocess.run(["g++", "-fsanitize=thread", "-xc++", "-", "-o", probe],
                           input="int main(){return 0;}", capture_output=True, text=True,
                           timeout=120)
        return r.returncode == 0 and subprocess.run([probe], capture_output=True,
                                                    timeout=60).returncode == 0
    except OSError:
        return False
    finally:
        if os.path.exists(probe):
            os.remove(probe)


def _records(violations: List[Violation], root: str, summary: dict) -> List[dict]:
    """The ``kind="analysis"`` stream: one record a violation, then the
    summary; raises ``ValueError`` on a record the schema refuses."""
    recs = [
        stamp({
            "rule": v.rule,
            "path": os.path.relpath(v.path, root) if os.path.isabs(v.path) else v.path,
            "line": v.line,
            "message": v.message,
            "suppressed": v.suppressed,
            "reason": v.reason,
        }, kind="analysis")
        for v in violations
    ] + [stamp({"rule": "summary", **summary}, kind="analysis")]
    for rec in recs:
        errs = check_record(rec)
        if errs:  # self-lint: the analyzer must obey the contract
            raise ValueError(f"malformed analysis record: {errs}")
    return recs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ddlpc_tpu_torch.analysis.check",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_REPO, help="tree to analyze (default: this repo)")
    ap.add_argument("--rules", default=None, help="comma-separated rule ids (default: all)")
    ap.add_argument("--out", default=None, help="write the kind='analysis' JSONL stream here")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--lockcheck-fixture",
                    default="ddlpc_tpu_torch.analysis.lock_fixtures:run_smoke",
                    help="module:callable to run under lockcheck")
    ap.add_argument("--sanitize", action="store_true",
                    help="also build and run kernels/host/batch.cc's self-test under "
                    "ASan, UBSan and (where it works) TSan")
    ap.add_argument("--programs", action="store_true",
                    help="the program auditor: one step of each arm under the collective "
                    "census, held to its closed forms and to the committed baseline")
    ap.add_argument("--device", default="cuda",
                    help="--programs: the ranks' device, a card (default; every rank on "
                    "cuda:0) or cpu")
    ap.add_argument("--arms", default=None,
                    help="--programs: comma-separated arms (default: all)")
    ap.add_argument("--inject", default=None,
                    help="--programs: run one injected fault instead (extra-collective, "
                    "fp32-widen, replicated-leaf); must exit 1")
    ap.add_argument("--baseline", default=None,
                    help="--programs: the baseline to compare with or write (default "
                    "docs/port_analysis/program_baseline.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="--programs: write the audited programs' entries into the baseline "
                    "instead of comparing")
    args = ap.parse_args(argv)

    if args.programs:
        return programs_main(args)
    if (args.device != "cuda" or args.arms or args.inject or args.baseline
            or args.update_baseline):
        print("ddlpc_check: --device, --arms, --inject, --baseline and --update-baseline go "
              "with --programs", file=sys.stderr)
        return 2
    if args.list_rules:
        for r in make_rules():
            print(f"{r.id:14s} {r.doc}")
        for extra in EXTRA_RULES:
            print(f"{extra:14s} (import tiers, lock smoke, suppressions)")
        return 0

    t0 = time.perf_counter()
    rule_ids = set(args.rules.split(",")) if args.rules else None
    if rule_ids is not None:
        unknown = rule_ids - set(ALL_RULE_IDS)
        if unknown:
            # a typo'd --rules must not pass as "0 violations, 0 rules run"
            print(f"ddlpc_check: unknown rule id(s): {', '.join(sorted(unknown))} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2
    root = os.path.abspath(args.root)
    result = run_analysis(root, rule_ids=rule_ids)
    violations = list(result.violations)

    if rule_ids is None or {"lock-order", "guarded-by"} & rule_ids:
        try:
            violations.extend(_run_lock_fixture(args.lockcheck_fixture))
        except Exception as e:  # the CLI's boundary: report, exit 2
            print(f"ddlpc_check: lockcheck fixture failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
    if args.sanitize:
        violations.extend(sanitize(root, log=lambda m: print(m, file=sys.stderr)))

    unsuppressed = [v for v in violations if not v.suppressed]
    suppressed = [v for v in violations if v.suppressed]
    for v in violations:
        print(v.format().replace(root + os.sep, ""))
    duration = time.perf_counter() - t0
    if args.out:
        try:
            recs = _records(violations, root, {
                "files_scanned": result.files_scanned,
                "violations": len(unsuppressed),
                "suppressed": len(suppressed),
                "duration_s": round(duration, 3),
                "rules_run": ",".join(result.rules_run),
            })
        except ValueError as e:
            print(f"ddlpc_check: {e}", file=sys.stderr)
            return 2
        atomic_write_text(args.out, "".join(json.dumps(r) + "\n" for r in recs))
    print(f"ddlpc_check: {result.files_scanned} files, {len(unsuppressed)} violation(s), "
          f"{len(suppressed)} suppressed (with reasons), {duration:.1f}s", file=sys.stderr)
    return 1 if unsuppressed else 0


def programs_main(args) -> int:
    """``--programs``: the program auditor over the arms (or one
    injection), its violations printed, its ``kind="program"`` stream
    written; 0 clean, 1 violations, 2 usage."""
    # torch-tier, reached here only: this module stays stdlib.
    from ddlpc_tpu_torch.analysis import program

    if args.inject in program.NO_EAGER_INJECTIONS:
        print(f"program_audit: --inject {args.inject} has no eager counterpart: the port runs no "
              "compiled program whose fences could be dropped (analysis/program.py)",
              file=sys.stderr)
        return 2
    if args.inject is not None and args.inject not in program.INJECTIONS:
        print(f"program_audit: unknown injection {args.inject!r} (one of "
              f"{', '.join(program.INJECTIONS + program.NO_EAGER_INJECTIONS)})", file=sys.stderr)
        return 2
    if args.inject is not None and args.update_baseline:
        print("program_audit: --inject and --update-baseline do not go together",
              file=sys.stderr)
        return 2
    if args.inject is not None:
        arms = []
    elif args.arms:
        arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    else:
        arms = list(program.ARMS)
    unknown = [a for a in arms if a not in program.ARMS]
    if unknown or (args.arms is not None and not arms):
        print(f"program_audit: unknown arm(s): {', '.join(unknown) or repr(args.arms)} "
              f"(one of {', '.join(program.ARMS)})", file=sys.stderr)
        return 2
    try:
        program.resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"program_audit: {e}", file=sys.stderr)
        return 2
    path = args.baseline or program.DEFAULT_BASELINE
    baseline = None
    if args.inject is None and (not args.update_baseline or os.path.exists(path)):
        try:
            baseline = program.load_baseline(path)
        except (OSError, ValueError) as e:
            print(f"program_audit: the baseline: {e}", file=sys.stderr)
            return 2
    result = program.audit(arms, args.device, [args.inject] if args.inject else [])
    audits = result["audits"]
    drift: list = []
    if args.update_baseline:
        atomic_write_json(path, program.build_baseline(audits, baseline), indent=1)
        print(f"program_audit: wrote {len(audits)} program(s) into {os.path.relpath(path, _REPO)}",
              file=sys.stderr)
    elif baseline is not None:
        for w in program.baseline_warnings(baseline):
            print(f"program_audit: WARNING {w}", file=sys.stderr)
        drift = program.drift(audits, baseline, every_program=set(arms) == set(program.ARMS))
        for v in drift:
            for a in audits:
                if a["program"] == v.program:
                    a["violations"].append(v)
    violations = [v for a in audits for v in a["violations"]]
    violations += [v for v in drift if v.program not in {a["program"] for a in audits}]
    for a in audits:
        for e in a["exceptions"]:
            print(f"program_audit: {a['program']}: named exception {e}")
    for v in violations:
        print(f"program_audit: {v.format()}")
    if args.out:
        recs = [stamp(program.to_record(a), kind="program") for a in audits]
        recs += [stamp({"record": "violation", "program": v.program, "contract": v.contract,
                        "message": v.message}, kind="program") for v in violations]
        recs.append(stamp({"record": "summary", "arms": len(set(a["arm"] for a in audits)),
                           "programs": len(audits), "violations": len(violations),
                           "census_drift": sum(v.contract == "census-drift" for v in violations),
                           "baseline": os.path.relpath(path, _REPO) if baseline else None,
                           "device": result["device"], "world": result["world"],
                           "seconds": round(result["seconds"], 3)}, kind="program"))
        for rec in recs:
            errs = check_record(rec)
            if errs:
                print(f"program_audit: malformed record: {errs}", file=sys.stderr)
                return 2
        atomic_write_text(args.out, "".join(json.dumps(r) + "\n" for r in recs))
    what = (f"--inject {args.inject}" if args.inject
            else f"{len(arms)} arm(s), {len(audits)} program(s)")
    print(f"program_audit: {what} on {result['device']} in a world of {result['world']}: "
          f"{len(violations)} violation(s), {len(drift)} of them census-drift, "
          f"{result['seconds']:.1f}s", file=sys.stderr)
    if args.inject is not None and not violations:
        print(f"program_audit: INJECTION NOT CAUGHT: {args.inject} produced no violation",
              file=sys.stderr)
        return 2
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
