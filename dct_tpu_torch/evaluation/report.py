"""Eval-report pretty-printer: the run inspector's evaluation sibling (a
copy of ``dct_tpu/evaluation/report.py``).

Usage::

    python -m dct_tpu_torch.evaluation.report <dir> [--events <events_dir>]

``<dir>`` is a challenger package dir (holding ``eval_report.json``),
a tracking artifacts tree, or any parent — every ``eval_report.json``
below it is rendered: champion vs challenger aggregate and per-slice
metrics, the bootstrap/sign statistics, drift PSI/KS per feature, and
the ``deploy.gate`` decisions found in the event log. Read-only over
the artifacts; missing surfaces degrade to "(none found)", never
errors — like the run inspector, partial evidence is exactly when an
operator reaches for this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def find_reports(root: str) -> list[str]:
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        if "eval_report.json" in filenames:
            out.append(os.path.join(dirpath, "eval_report.json"))
    return out


def load_gate_events(events_dir: str | None) -> list[dict]:
    if not events_dir:
        return []
    path = os.path.join(events_dir, "events.jsonl")
    if os.path.isfile(events_dir):
        path = events_dir
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    out = []
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("event") == "deploy.gate":
            out.append(rec)
    return out


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def render_report(report: dict, path: str) -> str:
    """One eval report as a printable block (pure function of the
    artifact — unit-testable without capturing stdout)."""
    lines = []
    lines.append("=" * 72)
    lines.append(f"Evaluation report — {path}")
    lines.append("=" * 72)
    champ, chall = report.get("champion", {}), report.get("challenger", {})
    lines.append(
        f"  {'':14s} {'loss':>10s} {'accuracy':>10s} {'n':>8s}"
    )
    for label, side in (("champion", champ), ("challenger", chall)):
        lines.append(
            f"  {label:14s} {_fmt(side.get('loss_mean', '?')):>10s} "
            f"{_fmt(side.get('accuracy', '?')):>10s} "
            f"{str(side.get('n', '?')):>8s}"
        )
    md = report.get("mean_delta")
    if md is not None:
        verdict = "challenger better" if md > 0 else (
            "challenger worse" if md < 0 else "tied"
        )
        lines.append(
            f"  mean paired delta (champion - challenger): "
            f"{_fmt(md)}  ({verdict})"
        )
    boot = report.get("bootstrap")
    if boot:
        lines.append(
            f"  bootstrap: p_better={_fmt(boot.get('p_better'))} "
            f"90% band [{_fmt(boot.get('ci_low'))}, "
            f"{_fmt(boot.get('ci_high'))}] over n={boot.get('n')}"
        )
    sign = report.get("sign_test")
    if sign:
        lines.append(
            f"  sign test: {sign.get('wins')} wins / "
            f"{sign.get('losses')} losses, p={_fmt(sign.get('p_value'))}"
        )
    slices = chall.get("slices") or {}
    if slices:
        lines.append("")
        lines.append("  Slices (challenger vs champion loss):")
        regressions = report.get("slice_regressions", {})
        for name in sorted(slices):
            ch = slices[name]
            cp = (champ.get("slices") or {}).get(name, {})
            reg = regressions.get(name)
            tag = ""
            if reg is not None:
                tag = f"  Δ{_fmt(reg)}" + (" (regressed)" if reg > 0 else "")
            lines.append(
                f"    {name:16s} {_fmt(ch.get('loss'))} vs "
                f"{_fmt(cp.get('loss', '?'))} "
                f"(acc {_fmt(ch.get('accuracy'))}, n={ch.get('n')}){tag}"
            )
    drift = report.get("drift")
    lines.append("")
    lines.append("  Drift vs champion's training snapshot:")
    if drift:
        lines.append(
            f"    max_psi={_fmt(drift.get('max_psi'))} "
            f"(threshold {_fmt(drift.get('psi_threshold'))}) "
            f"any_drift={drift.get('any_drift')}"
        )
        for name in sorted(drift.get("features", {})):
            f = drift["features"][name]
            if "psi" in f:
                lines.append(
                    f"    {name:20s} psi={_fmt(f['psi'])} "
                    f"ks={_fmt(f['ks'])}"
                    + ("  DRIFTED" if f.get("drifted") else "")
                )
            else:
                lines.append(f"    {name:20s} schema drift: {f}")
    else:
        lines.append("    (no snapshot in the champion package)")
    return "\n".join(lines)


def render_gate_events(events: list[dict]) -> str:
    lines = ["", "Gate decisions (deploy.gate events):"]
    if not events:
        lines.append("  (none found)")
        return "\n".join(lines)
    for r in events:
        lines.append(
            f"  {r.get('run_id', '?')}  stage={r.get('stage')} "
            f"decision={r.get('decision')} reason={r.get('reason')} "
            f"mean_delta={_fmt(r.get('mean_delta', '?'))}"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dct_tpu_torch.evaluation.report",
        description=(
            "Pretty-print champion/challenger eval reports, drift "
            "metrics, and gate decisions."
        ),
    )
    parser.add_argument(
        "root",
        help="package dir, eval_report.json, or a parent to search",
    )
    parser.add_argument(
        "--events", default=os.environ.get("DCT_EVENTS_DIR", "logs/events"),
        help="events dir (or events.jsonl) for deploy.gate decisions",
    )
    args = parser.parse_args(argv)
    if not os.path.exists(args.root):
        print(f"error: {args.root} does not exist", file=sys.stderr)
        return 2
    reports = find_reports(args.root)
    if not reports:
        print(f"(no eval_report.json under {args.root})")
    for path in reports:
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, ValueError) as e:
            print(f"(unreadable report {path}: {e})", file=sys.stderr)
            continue
        print(render_report(report, path))
    print(render_gate_events(load_gate_events(args.events)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
