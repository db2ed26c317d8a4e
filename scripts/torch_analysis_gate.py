"""Invariant gate of the PyTorch port: audit every registered hot path of
``repro_torch`` and FAIL (exit 1) on an invariant violation, an AST-lint
finding, or metric drift against the committed baseline — the port's
counterpart of ``scripts/analysis_gate.py``.

What runs:

* ``repro_torch.analysis`` audits every registered program (the
  ``DataMesh`` collective census, the materialization bound, float64
  arrays, host reads, kernel launches, in-place state) — see
  ``docs/TORCH_INVARIANTS.md``. On the CPU (``--device cpu``) each program
  is traced under fake tensors, never executed; on the card (the default)
  it runs for real, synchronizing calls counted as host reads.
* ``repro_torch.analysis.ast_lints`` lints ``src/repro_torch``.
* The measured metrics are written to
  ``results/analysis/TORCH_ANALYSIS_report.json`` and diffed exactly
  against the committed baseline ``src/repro_torch/analysis/baseline.json``
  (the CPU's metrics; on the card only the metrics that do not depend on
  where the program ran: the census and its bytes, host reads, kernel
  launches, float64 arrays, in-place state).

A change that intentionally changes a program's structure regenerates the
baseline in the same change (``--write-baseline``, on the CPU).

Usage::

    python scripts/torch_analysis_gate.py --device cpu
    python scripts/torch_analysis_gate.py --device cpu --programs streamed_nll_sharded
    python scripts/torch_analysis_gate.py --device cpu --write-baseline
    python scripts/torch_analysis_gate.py --device cpu --seed-violation extra_psum  # exits 1
    python scripts/torch_analysis_gate.py            # on the card
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO_ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(REPO_ROOT, "src"))

BASELINE = os.path.join("src", "repro_torch", "analysis", "baseline.json")
REPORT_DIR = os.path.join("results", "analysis")
LINT_ROOT = os.path.join("src", "repro_torch")


def run_audits(names: list[str] | None, device) -> list[dict]:
    from repro_torch.analysis import all_programs, audit_program, get_program

    specs = [get_program(n) for n in names] if names else all_programs()
    reports = []
    for spec in specs:
        print(f"auditing {spec.name} ...", flush=True)
        reports.append(audit_program(spec, device=device))
    return reports


def diff_baseline(reports: list[dict], baseline_path: str, keys=None) -> list[str]:
    """Exact metric diff: any drift is a failure (``keys``: only these)."""
    if not os.path.exists(baseline_path):
        return [f"missing baseline {baseline_path} — run `python scripts/torch_analysis_gate.py "
                f"--device cpu --write-baseline` and commit it"]
    with open(baseline_path) as f:
        base_programs: dict = json.load(f).get("programs", {})
    problems, seen = [], set()
    for rep in reports:
        name = rep["name"]
        seen.add(name)
        if name not in base_programs:
            problems.append(f"{name}: not in baseline — regenerate with --write-baseline")
            continue
        want, got = base_programs[name], rep["metrics"]
        for k in sorted(set(want) | set(got)):
            if keys is not None and k not in keys:
                continue
            if want.get(k) != got.get(k):
                problems.append(f"{name}: metric {k} drifted: baseline {want.get(k)!r} → "
                                f"measured {got.get(k)!r}")
    for name in sorted(set(base_programs) - seen):
        problems.append(f"{name}: in baseline but not audited — deleted program? regenerate "
                        f"with --write-baseline")
    return problems


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--programs", default=None,
                    help="comma-separated subset of program names (subset runs skip the "
                         "baseline diff)")
    ap.add_argument("--device", default=None,
                    help="where the programs run: the card unless 'cpu' is asked for")
    ap.add_argument("--baseline", default=BASELINE)
    ap.add_argument("--report-dir", default=REPORT_DIR)
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the measured metrics as the new baseline (CPU only)")
    ap.add_argument("--seed-violation", default=None,
                    help="audit a deliberately broken program from "
                         "repro_torch.analysis.violations; the gate MUST exit 1")
    args = ap.parse_args(argv)
    os.chdir(REPO_ROOT)
    import torch

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    torch.set_num_threads(min(torch.get_num_threads(), 4))

    if args.seed_violation is not None:
        from repro_torch.analysis import audit_program
        from repro_torch.analysis.violations import VIOLATIONS

        if args.seed_violation not in VIOLATIONS:
            print(f"unknown violation {args.seed_violation!r} "
                  f"(known: {', '.join(sorted(VIOLATIONS))})")
            return 2
        rep = audit_program(VIOLATIONS[args.seed_violation], device=device)
        for f in rep["failures"]:
            print(f"  ! {rep['name']}: {f}")
        if rep["ok"]:
            print(f"VIOLATION MISSED: {args.seed_violation} audited clean — the gate has lost "
                  f"its teeth")
            return 0  # distinguishable from detection in tests: 0 == missed
        print(f"violation {args.seed_violation!r} detected; failing as it should")
        return 1

    names = args.programs.split(",") if args.programs else None
    reports = run_audits(names, device)
    failures = [f"{rep['name']}: {f}" for rep in reports for f in rep["failures"]]

    from repro_torch.analysis.ast_lints import lint_paths

    lint_findings = lint_paths(LINT_ROOT)
    failures.extend(f"lint: {f}" for f in lint_findings)

    report = {
        "torch": torch.__version__,
        "device": device.type,
        "programs": {r["name"]: r["metrics"] for r in reports},
        "failures": failures,
        "lint_findings": [str(f) for f in lint_findings],
    }
    os.makedirs(args.report_dir, exist_ok=True)
    report_path = os.path.join(args.report_dir, "TORCH_ANALYSIS_report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f"wrote {report_path} ({len(reports)} programs audited on {device.type})")

    if args.write_baseline:
        if names is not None or device.type != "cpu":
            print("refusing to --write-baseline from a --programs subset or off the CPU")
            return 2
        with open(args.baseline, "w") as f:
            json.dump({"programs": report["programs"]}, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote baseline {args.baseline}")

    if names is None:
        from repro_torch.analysis.checks import PORTABLE_METRICS

        failures.extend(diff_baseline(reports, args.baseline,
                                      None if device.type == "cpu" else PORTABLE_METRICS))

    if failures:
        print(f"\nTORCH ANALYSIS GATE: FAIL ({len(failures)} problem(s))")
        for f in failures:
            print(f"  ! {f}")
        return 1
    print(f"\nTORCH ANALYSIS GATE: OK — {len(reports)} programs within budget, "
          f"{len(lint_findings)} lint findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
