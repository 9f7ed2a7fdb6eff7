"""The golden criteria of the demo families, and a run of one family.

A copy of benchmarks/golden_parity.py's criteria (lines 82-212: the
smoothed final ELBO, the trajectory tail's robust spread, assignment
purity, the best expert's RMSE, permutation accuracy, ``evaluate_checks``
with its figure and robustness tiers) and of its per-family ELBO
aggregate (lines 385-440, ``aggregate``), with the reference targets read
off the reference's converged figures (``FAMILIES``).  ``run_family``
trains one family through the port's demo runner and measures its row as
golden_parity.run_family does.

Tiers: "figure" holds seed 0 of the CPU float64 run, the draw the
reference figure pins; "robustness" holds any other run, such as a run on
the card, whose noise is torch's Philox stream in float32 and so not the
figure's draw.
"""
from __future__ import annotations

import itertools

import numpy as np

__all__ = ["MIN_ELBO_TOL", "FAMILIES", "smoothed_final_elbo",
           "tail_robust_sd", "assignment_purity", "best_expert_rmse",
           "perm_accuracy", "evaluate_checks", "aggregate", "run_family"]

# The ELBO tolerance's floor: the per-minibatch estimator's own noise plus
# the error of reading the reference figures.
MIN_ELBO_TOL = 0.15

# name: the reference's converged ELBO, read off its figure.
FAMILIES = {
    "demo_multimodal_1d": -0.1,
    "demo_multimodal_1d_modified": -1.0,
    "demo_multiclass_1d": 1.5,
    "demo_2d": -3.0,
    "demo_multiclass_2d": 1.05,
    "demo_john_doe": 2.0,
    "demo_john_doe_multiclass": 1.4,
}


def _tail(elbos, frac=0.25):
    return np.asarray(elbos[max(1, int(len(elbos) * (1 - frac))):], float)


def smoothed_final_elbo(elbos, frac=0.25):
    """The 75th percentile of the last ``frac`` of the trajectory: the
    reference figures' plateau is the trajectory's upper envelope."""
    return float(np.percentile(_tail(elbos, frac), 75))


def tail_robust_sd(elbos, frac=0.25):
    """IQR / 1.349 of the trajectory's tail: the run's own noise scale."""
    q75, q25 = np.percentile(_tail(elbos, frac), [75, 25])
    return float((q75 - q25) / 1.349)


def assignment_purity(assign_probs, labels):
    """Mean over the true groups of the dominant expert's share."""
    hard = np.argmax(assign_probs, axis=-1)
    purities = []
    for g in np.unique(labels):
        counts = np.bincount(hard[labels == g], minlength=assign_probs.shape[-1])
        purities.append(counts.max() / counts.sum())
    return float(np.mean(purities))


def best_expert_rmse(fmean, labels, truth):
    """Per group, the RMSE of each point's best expert."""
    fm = np.asarray(fmean).mean(0)                      # [N, K]
    err = np.min(np.abs(fm - np.asarray(truth)[:, None]), axis=1)
    return [float(np.sqrt(np.mean(err[labels == g] ** 2)))
            for g in np.unique(labels)]


def perm_accuracy(pred_class, labels):
    """Classification accuracy, the best over label permutations."""
    classes = np.unique(labels)
    best = 0.0
    for perm in itertools.permutations(range(len(classes))):
        mapped = np.array([perm[c] for c in pred_class])
        best = max(best, float(np.mean(mapped == labels)))
    return best


def evaluate_checks(name, row, tier="figure"):
    """The quality checks of one family's row at ``tier`` ("figure" or
    "robustness"), as benchmarks/golden_parity.py:152-212 states them."""
    checks = {}
    fig = tier == "figure"
    if name.startswith("demo_multimodal_1d"):
        modified = name.endswith("modified")
        checks["purity"] = bool(row["assign_purity"] >= (0.65 if fig else 0.45))
        checks["rmse"] = bool(max(row["branch_rmse"])
                              <= (0.15 if fig else (0.45 if modified else 0.2)))
    elif name == "demo_2d":
        checks["sheet_tracking"] = bool(max(row["sheet_rmse"]) <= 1.5)
        checks["distinct_trackers"] = bool(
            row["sheet_trackers"][0] != row["sheet_trackers"][1])
        checks["separation"] = bool(8.0 <= row["sheet_separation"] <= 12.0)
        checks["off_expert"] = bool(min(row["expert_mass"]) <= 0.10)
    elif name in ("demo_multiclass_1d", "demo_multiclass_2d"):
        checks["accuracy"] = bool(row["accuracy_vs_clean"] >= 0.95)
    elif name == "demo_john_doe":
        means = np.asarray(row["expert_means"])
        checks["rmse"] = bool(row["best_expert_rmse"] <= 1.2)
        checks["low_experts"] = bool(np.min(np.abs(means - 0.0)) <= 0.35
                                     and np.min(np.abs(means - 1.0)) <= 0.35)
        checks["boundary_expert"] = bool(np.max(means) >= 3.0)
    elif name == "demo_john_doe_multiclass":
        checks["accuracy"] = bool(
            row["accuracy_vs_labels"] >= row["majority_base_rate"] - 0.01)
    return checks


def aggregate(rows, target):
    """One family's ELBO tolerances and checks over its seeds' rows, as
    benchmarks/golden_parity.py:385-440 aggregates them: the figure tier's
    tolerance max(2 x the best healthy seed's tail spread, MIN_ELBO_TOL)
    (at most 1), the robustness tier's max(3 x the seeds' IQR / 1.349, the
    figure tolerance, 2 x MIN_ELBO_TOL)."""
    healthy = [r for r in rows if r["pass"]]
    basin_failures = len(rows) - len(healthy)
    elbos = np.array([r["elbo"] for r in healthy or rows])
    seed0 = next((r for r in rows if r["seed"] == 0), rows[0])
    best = max(healthy or rows, key=lambda r: r["elbo"])
    tol_fig = float(np.clip(2.0 * best.get("elbo_tail_rsd", 0.0),
                            MIN_ELBO_TOL, 1.0))
    if len(elbos) > 1:
        q75, q25 = np.percentile(elbos, [75, 25])
        robust_sd = float(q75 - q25) / 1.349
    else:
        robust_sd = 0.0
    tol_robust = max(3.0 * robust_sd, tol_fig, 2.0 * MIN_ELBO_TOL)
    elbo_ok = bool(np.sum(elbos < target - tol_robust)
                   <= max(1, len(elbos) // 4))
    fam = {"elbo": round(float(elbos.mean()), 4),
           "elbo_best_seed": best["seed"], "elbo_best": best["elbo"],
           "elbo_robust_sd": round(robust_sd, 4),
           "elbo_tol_figure": round(tol_fig, 4),
           "elbo_tol_robust": round(tol_robust, 4),
           "ref_elbo_target": target,
           "basin_failures": f"{basin_failures}/{len(rows)}",
           "checks": {"elbo_figure_best_seed":
                      bool(best["elbo"] >= target - tol_fig),
                      "elbo_healthy_seeds": elbo_ok,
                      "figure_parity_seed0": seed0["pass"],
                      "basin_failure_rate": basin_failures
                      <= max(1, len(rows) // 4)}}
    fam["pass"] = all(fam["checks"].values())
    return fam


def run_family(name, seed=0, iters_frac=1.0, platform="gpu", argv=()):
    """Train family ``name`` through the demo runner on ``platform`` (the
    card's float32, or "cpu": float64; ``argv``: more demo flags) and return
    its row: the smoothed final ELBO and tail spread, the family's quality
    measures on its training inputs, and ``evaluate_checks`` at the
    "figure" tier for seed 0 on the CPU, else at "robustness"."""
    import dataclasses
    import importlib

    import torch

    from modulatedgps_tpu_torch.demos._runner import run

    cfg = importlib.import_module(f"modulatedgps_tpu_torch.demos.{name}").CONFIG
    if iters_frac != 1.0:
        cfg = dataclasses.replace(cfg, iters=max(50, int(cfg.iters * iters_frac)))
    model, iters, elbos = run(cfg, argv=["--no-plot", "--platform", platform,
                                         "--seed", str(seed), *argv])
    row = {"iters": cfg.iters, "seed": seed,
           "elbo": round(smoothed_final_elbo(elbos), 4),
           "elbo_tail_rsd": round(tail_robust_sd(elbos), 4),
           "ref_elbo_target": FAMILIES[name]}

    N, Xtrain, Ytrain = cfg.load_data(np.random.default_rng(seed))[:3]
    Z = model.pred_layer.Z.value
    X = torch.as_tensor(np.asarray(Xtrain, np.float64), dtype=Z.dtype,
                        device=Z.device)
    with torch.no_grad():
        assign_probs = model.predict_assign(X).cpu().numpy()
        fmean = model.predict_y(X)[0].cpu().numpy()
    fm = fmean.mean(0)                                    # [N, K]

    if name.startswith("demo_multimodal_1d"):
        labels = np.repeat([0, 1, 2], N // 3)
        x = Xtrain[:, 0]
        truth = np.where(
            labels == 0, np.sin(x),
            np.where(labels == 1, np.sin(x) - 2 * np.exp(-0.5 * (x - 2) ** 2),
                     -2 - (3 / (8 * np.pi)) * x + 0.3 * np.sin(2 * x)))
        row.update(assign_purity=round(assignment_purity(assign_probs, labels), 3),
                   branch_rmse=[round(r, 3) for r in
                                best_expert_rmse(fmean, labels, truth)])
    elif name == "demo_2d":
        radial = np.sqrt((Xtrain[:, 0] - 0.5) ** 2 + (Xtrain[:, 1] - 0.5) ** 2)
        rmse_ks = np.array([[float(np.sqrt(np.mean((fm[:, k] - s) ** 2)))
                             for k in range(fm.shape[1])]
                            for s in (radial, radial + 10.0)])
        trackers = rmse_ks.argmin(axis=1)
        labels = np.repeat([0, 1], N // 2)
        row.update(assign_purity=round(assignment_purity(assign_probs, labels), 3),
                   sheet_rmse=[round(float(r), 3) for r in rmse_ks.min(axis=1)],
                   sheet_trackers=[int(t) for t in trackers],
                   sheet_separation=round(float(np.mean(
                       fm[:, trackers[1]] - fm[:, trackers[0]])), 3),
                   expert_mass=[round(float(m), 3)
                                for m in assign_probs.mean(axis=0)])
    elif name in ("demo_multiclass_1d", "demo_multiclass_2d"):
        if name == "demo_multiclass_1d":
            clean = (Xtrain[:, 0] < 0.0).astype(int)
        else:
            clean = ((Xtrain[:, 0] < 0) & (Xtrain[:, 1] < 0)).astype(int)
        row.update(accuracy_vs_clean=round(
            perm_accuracy(np.argmax(fm, axis=-1), clean), 3))
    elif name == "demo_john_doe":
        y = np.asarray(Ytrain[:, 0], float)
        err = np.min(np.abs(fm - y[:, None]), axis=1)
        row.update(best_expert_rmse=round(float(np.sqrt(np.mean(err ** 2))), 3),
                   expert_means=[round(float(m), 3) for m in fm.mean(axis=0)])
    elif name == "demo_john_doe_multiclass":
        y = np.asarray(Ytrain[:, 0], int)
        base = float(max(np.mean(y), 1.0 - np.mean(y)))
        row.update(accuracy_vs_labels=round(
            perm_accuracy(np.argmax(fm, axis=-1), y), 3),
                   majority_base_rate=round(base, 3))

    tier = "figure" if seed == 0 and platform == "cpu" else "robustness"
    row["tier"] = tier
    row["checks"] = evaluate_checks(name, row, tier)
    row["pass"] = all(row["checks"].values())
    return row


def main(argv=None):
    """Print one JSON row per (family, seed) of ``run_family``, at the
    given base jitter (the f32 floor applies on the card):

        python -m modulatedgps_tpu_torch.demos.golden --platform cpu \\
            --families demo_john_doe --seeds 0 1 2 3 --jitter 1e-4
    """
    import argparse
    import json

    from modulatedgps_tpu_torch.config import config_context

    p = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    p.add_argument("--families", nargs="+", default=list(FAMILIES),
                   choices=list(FAMILIES))
    p.add_argument("--seeds", nargs="+", type=int, default=[0])
    p.add_argument("--jitter", type=float, default=None)
    p.add_argument("--iters-frac", type=float, default=1.0)
    args = p.parse_args(argv)
    with config_context(jitter=args.jitter):
        for name in args.families:
            for seed in args.seeds:
                row = run_family(name, seed, args.iters_frac, args.platform)
                print(json.dumps({"family": name, "jitter": args.jitter,
                                  "platform": args.platform, **row}),
                      flush=True)


if __name__ == "__main__":
    main()
