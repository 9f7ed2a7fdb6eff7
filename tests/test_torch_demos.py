"""The port's demo layer against the JAX package's, on the CPU in f64.

Both runners build the same initial model from the same seed (every raw
leaf equal, a softplus inverse to its last bit); a model trained a few steps by the JAX demo and saved by its
--checkpoint is restored by the port's --resume and served through
precompute_smgp with the JAX package's outputs within 1e-8 relative.
Every one of the nine ported CLIs runs through main(argv) with --platform
cpu at tests/test_demo_scripts.py's iteration counts, one through python
-m, the 1-D and 2-D figure branches write their PNGs, a checkpointed run
resumes and reports the restored ELBO, and without --platform cpu and
without a card each exits non-zero.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu.data import (load_toy_data_categorical,
                                   load_toy_multimodal_data)
from modulatedgps_tpu.models.posterior import precompute_smgp as jprecompute

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "demos") not in sys.path:
    sys.path.insert(0, str(REPO / "demos"))
import _runner as jrunner  # noqa: E402  (the JAX demos' runner)

JAX_CONFIGS = {
    "demo_multimodal_1d": jrunner.DemoConfig(
        name="demo_multimodal_1d", load_data=load_toy_multimodal_data, K=3,
        iters=2000, pred_kernel=(0.5, 0.5), assign_kernel=(0.1, 1.0)),
    "demo_multiclass_1d": jrunner.DemoConfig(
        name="demo_multiclass_1d", load_data=load_toy_data_categorical, K=2,
        iters=2000, pred_kernel=(0.1, 1.0), assign_kernel=(0.1, 1.0),
        multiclass=True),
}
CPU = ["--platform", "cpu", "--no-plot", "--predict-samples", "2"]
TINY = ("--iters", "20", "--predict-samples", "10")
# tests/test_demo_scripts.py's budgets for each CLI.
CLIS = {"demo_multimodal_1d": ("--iters", "30"),
        "demo_multimodal_1d_modified": TINY,
        "demo_multiclass_1d": TINY,
        "demo_2d": TINY,
        "demo_multiclass_2d": TINY,
        "demo_john_doe": TINY,
        "demo_john_doe_multiclass": TINY,
        "demo_svgp": ("--iters", "20", "--debug-nans"),
        "demo_multiclass_svgp": ("--iters", "30")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU runs are many small ops: one intra-op thread keeps them
    from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _demo(name):
    return importlib.import_module(f"modulatedgps_tpu_torch.demos.{name}")


def _leaves(tree):
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_run(name, argv):
    from modulatedgps_tpu_torch.demos._runner import run
    return run(_demo(name).CONFIG, argv)


@pytest.mark.parametrize("name", list(JAX_CONFIGS))
def test_runners_build_the_same_initial_model(name):
    jmodel, _, _ = jrunner.run(JAX_CONFIGS[name], CPU + ["--iters", "0"])
    model, iters, elbos = _port_run(name, CPU + ["--iters", "0"])
    assert iters == elbos == []
    want = _leaves(jmodel)
    got = pt.smgp_to_numpy(model)
    assert list(got) == list(want)
    positive = {n for n, m in model.named_modules()
                if getattr(m, "transform", None) == "positive"}
    for key in want:
        if key.removesuffix(".raw") in positive:
            # softplus^-1 of the same value: XLA's log / expm1 and libm's
            # may differ in the last bit
            np.testing.assert_allclose(got[key], want[key], rtol=4e-16,
                                       err_msg=key)
        else:   # k-means Z, zero q_mu, identity q_sqrt: the same bits
            assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("name", list(JAX_CONFIGS))
def test_resumed_jax_model_serves_like_jax(name, tmp_path, capsys):
    path = str(tmp_path / "jax_model.npz")
    jmodel, _, _ = jrunner.run(JAX_CONFIGS[name],
                               CPU + ["--iters", "10", "--checkpoint", path])
    model, _, elbos = _port_run(name, CPU + ["--iters", "0", "--resume", path])
    assert elbos == [] and "restored ELBO" in capsys.readouterr().out
    N, Xtr, Ytr, Xte = JAX_CONFIGS[name].load_data(np.random.default_rng(0))
    jserve, serve = jprecompute(jmodel), pt.precompute_smgp(model)
    Xd, Yd = Xtr[:200], Ytr[:200]
    with torch.no_grad():
        got = [*serve.predict_y(torch.as_tensor(Xte)),
               serve.predict_assign(torch.as_tensor(Xte)),
               serve.predict_density(torch.as_tensor(Xd), torch.as_tensor(Yd))]
    want = [*jserve.predict_y(jnp.asarray(Xte)),
            jserve.predict_assign(jnp.asarray(Xte)),
            jserve.predict_density(jnp.asarray(Xd), jnp.asarray(Yd))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-12)


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_runs_on_the_cpu(name, capsys):
    out = _demo(name).main(["--platform", "cpu", "--no-plot", *CLIS[name]])
    text = capsys.readouterr().out
    assert "ELBO" in text or "RMSE" in text
    if isinstance(out, tuple):
        elbos = out[2]
    else:
        elbos = out["elbos"] if "elbos" in out else [out["elbo"]]
    assert elbos and np.all(np.isfinite(elbos))


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_without_a_card_exits_nonzero(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --platform gpu runs")
    with pytest.raises(SystemExit) as exc:
        _demo(name).main(["--iters", "1", "--no-plot"])
    assert exc.value.code not in (0, None)


def test_python_dash_m_runs_demo_2d():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "modulatedgps_tpu_torch.demos.demo_2d",
         "--platform", "cpu", "--no-plot", *TINY],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "final ELBO" in res.stdout


@pytest.mark.parametrize("name,files", [
    ("demo_multiclass_1d", ["demo_multiclass_1d.png"]),
    ("demo_2d", ["demo_2d_1.png", "demo_2d_2.png"])])
def test_figure_branches_write_pngs(name, files, tmp_path, capsys):
    _demo(name).main(["--platform", "cpu", "--out", str(tmp_path), *TINY])
    assert "figure ->" in capsys.readouterr().out
    for f in files:
        assert (tmp_path / f).stat().st_size > 0


def test_checkpoint_every_resumes_and_reports_restored_elbo(tmp_path, capsys):
    path = str(tmp_path / "state.npz")
    argv = ["--platform", "cpu", "--no-plot", "--iters", "10",
            "--predict-samples", "2", "--checkpoint", path,
            "--checkpoint-every", "5"]
    demo = _demo("demo_multimodal_1d_modified")
    _, iters, elbos = demo.main(argv)
    assert iters[-1] == 10 and os.path.exists(path)
    first = capsys.readouterr().out
    assert "final ELBO" in first
    model, iters, elbos = demo.main(argv)
    second = capsys.readouterr().out
    assert iters == elbos == []
    assert "resumed from" in second and "restored ELBO" in second
