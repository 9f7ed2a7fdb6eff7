"""The golden bars of the demo families, held by the port on the CPU in f64.

The five families of tests/test_golden_demos.py, built with the port's
constructors and trained by its run_adam for the same 300 iterations at the
same learning rate, clear the same bars.  demos/golden.py's criteria,
evaluate_checks and ELBO aggregate, applied to the per-seed rows of
GOLDEN_r04.json, return exactly what benchmarks/golden_parity.py's return
and what the artifact records (neither file is edited).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import modulatedgps_tpu_torch as pt
from benchmarks import golden_parity as ref
from modulatedgps_tpu_torch.data import (load_toy_2d_data,
                                         load_toy_2d_data_categorical,
                                         load_toy_data_assoc,
                                         load_toy_data_categorical,
                                         load_toy_multimodal_data,
                                         minibatch_iterator)
from modulatedgps_tpu_torch.demos import golden
from modulatedgps_tpu_torch.utils import kmeans_centers
from modulatedgps_tpu_torch.utils.evaluation import mixture_nlpd

F64 = dict(dtype=torch.float64, device="cpu")
REPO = Path(__file__).resolve().parents[1]
ARTIFACT = json.loads((REPO / "GOLDEN_r04.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU runs are many small ops: one intra-op thread keeps them
    from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(Xtr, N, K, pred_kv, assign_kv, multiclass=False, S=10):
    Z = kmeans_centers(Xtr, 25, seed=0)
    Za = kmeans_centers(Xtr, 25, seed=1)
    pred = pt.SVGP.create(pt.SquaredExponential.create(*pred_kv, **F64), Z,
                          num_latent_gps=K, **F64)
    assign = pt.SVGP.create(pt.SquaredExponential.create(*assign_kv, **F64),
                            Za, num_latent_gps=K, **F64)
    assign_lik = pt.Gaussian.create(0.5, D=K, **F64)
    if multiclass:
        return pt.SMGPModified(pt.MultiClass.create(K), pred, assign,
                               assign_likelihood=assign_lik, K=K,
                               num_samples=S, num_data=N)
    return pt.SMGP(pt.Gaussian.create(0.5, D=K, **F64), pred, assign, K=K,
                   num_samples=S, num_data=N)


def _train(model, Xtr, Ytr, iters=300, lr=0.01, seed=0):
    batches = ((torch.as_tensor(x), torch.as_tensor(y)) for x, y in
               minibatch_iterator(Xtr, Ytr, 500, seed=seed))
    _, _, elbos = pt.run_adam(model, iters, batches, lr, verbose=False,
                              generator=torch.Generator().manual_seed(seed))
    return elbos


def _class_accuracy(model, X, truth):
    with torch.no_grad():
        p, _ = model.likelihood.predict_mean_and_var(
            *model.pred_layer.predict_f(torch.as_tensor(X)))
    pred = np.argmax(p.numpy(), -1)
    return max(np.mean(pred == truth), np.mean(pred == 1 - truth))


def test_golden_multimodal_1d():
    N, Xtr, Ytr, Xte = load_toy_multimodal_data(np.random.default_rng(0))
    model = _build(Xtr, N, 3, (0.5, 0.5), (0.1, 1.0))
    elbos = _train(model, Xtr, Ytr)
    assert elbos[-1] > -1.5, f"ELBO {elbos[-1]}"
    nlpd = mixture_nlpd(model, Xtr, Ytr)
    assert nlpd < 0.5 * np.log(2 * np.pi * np.var(Ytr)) + 0.5, nlpd


def test_golden_categorical_1d():
    N, Xtr, Ytr, Xte = load_toy_data_categorical(np.random.default_rng(0))
    model = _build(Xtr, N, 2, (0.1, 1.0), (0.1, 1.0), multiclass=True)
    _train(model, Xtr, Ytr)
    assert _class_accuracy(model, Xte, (Xte[:, 0] < 0).astype(int)) > 0.85


def test_golden_2d():
    N, Xtr, Ytr, Xte = load_toy_2d_data(np.random.default_rng(0))
    model = _build(Xtr, N, 3, (0.5, 0.5), (0.1, 1.0))
    elbos = _train(model, Xtr, Ytr)
    assert elbos[-1] > -20, elbos[-1]
    assert elbos[-1] - elbos[0] > 30, (elbos[0], elbos[-1])


def test_golden_2d_categorical():
    N, Xtr, Ytr, Xte = load_toy_2d_data_categorical(np.random.default_rng(0))
    model = _build(Xtr, N, 2, (0.1, 1.0), (0.1, 1.0), multiclass=True)
    _train(model, Xtr, Ytr)
    truth = ((Xtr[:, 0] < 0) & (Xtr[:, 1] < 0)).astype(int)
    assert _class_accuracy(model, Xtr, truth) > 0.8


def test_golden_assoc_outliers():
    N, Xtr, Ytr, Xte = load_toy_data_assoc(np.random.default_rng(0))
    model = _build(Xtr, N, 2, (0.5, 0.5), (0.1, 1.0))
    elbos = _train(model, Xtr, Ytr)
    assert np.isfinite(elbos[-1])
    with torch.no_grad():
        share = model.predict_assign(torch.as_tensor(Xtr)).numpy().mean(0)
    assert share.min() > 0.05, share


ROWS = [(name, seed, row) for name, fam in ARTIFACT["families"].items()
        for seed, row in fam["seeds"].items()]


@pytest.mark.parametrize("name,seed,row", ROWS,
                         ids=[f"{n}-{s}" for n, s, _ in ROWS])
def test_evaluate_checks_match_golden_parity(name, seed, row):
    for tier in ("figure", "robustness"):
        assert golden.evaluate_checks(name, row, tier) == \
            ref.evaluate_checks(name, row, tier)
    assert golden.evaluate_checks(name, row, row["tier"]) == row["checks"]


@pytest.mark.parametrize("name", list(ARTIFACT["families"]))
def test_aggregate_matches_the_artifact(name):
    fam = ARTIFACT["families"][name]
    rows = [fam["seeds"][s] for s in sorted(fam["seeds"], key=int)]
    got = golden.aggregate(rows, golden.FAMILIES[name])
    assert golden.FAMILIES[name] == ref.FAMILIES[name] == fam["ref_elbo_target"]
    for key in ("elbo", "elbo_best_seed", "elbo_best", "elbo_robust_sd",
                "elbo_tol_figure", "elbo_tol_robust", "basin_failures",
                "checks", "pass"):
        assert got[key] == fam[key], key


def test_criteria_functions_match_golden_parity():
    rng = np.random.default_rng(0)
    for n in (7, 40, 401):
        elbos = list(rng.normal(-1.0, 0.3, n).cumsum() / n)
        assert golden.smoothed_final_elbo(elbos) == ref.smoothed_final_elbo(elbos)
        assert golden.tail_robust_sd(elbos) == ref.tail_robust_sd(elbos)
    probs = rng.dirichlet(np.ones(3), 300)
    labels = np.repeat([0, 1, 2], 100)
    fmean = rng.normal(size=(1, 300, 3))
    truth = rng.normal(size=300)
    assert golden.assignment_purity(probs, labels) == \
        ref.assignment_purity(probs, labels)
    assert golden.best_expert_rmse(fmean, labels, truth) == \
        ref.best_expert_rmse(fmean, labels, truth)
    pred = rng.integers(0, 2, 200)
    clean = rng.integers(0, 2, 200)
    assert golden.perm_accuracy(pred, clean) == ref.perm_accuracy(pred, clean)
    assert golden.MIN_ELBO_TOL == ref.MIN_ELBO_TOL


def test_golden_cli_prints_a_row_at_the_given_jitter(capsys):
    before = pt.config.default_jitter(torch.float64)
    golden.main(["--platform", "cpu", "--families", "demo_multimodal_1d",
                 "--iters-frac", "0.025", "--jitter", "1e-4"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (row["family"], row["jitter"], row["iters"], row["seed"]) == (
        "demo_multimodal_1d", 1e-4, 50, 0)
    assert np.isfinite(row["elbo"]) and set(row["checks"]) >= {"purity"}
    assert pt.config.default_jitter(torch.float64) == before
