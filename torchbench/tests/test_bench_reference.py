"""The plain references against the port's CPU path in float64, at a tiny
size: the same state, batch and noise give the same loss, gradients and
served outputs."""
import pytest
import torch

import modulatedgps_tpu_torch as pt

from conftest import tiny_cell
from torchbench.harness import state as st
from torchbench.harness.traffic import request_pool
from torchbench.reference import _plain

CPU = torch.device("cpu")


def _port_and_state(cell, seed=5):
    state = st.make_state(cell.config, seed, CPU)
    model = st.build_model(cell.config, state, CPU, torch.float64)
    return model, state


@pytest.mark.parametrize("name", ["smgp.train", "smgpmod_mc.train"])
def test_loss_and_gradients(name):
    cell = tiny_cell(name)
    cfg = cell.config
    model, state = _port_and_state(cell)
    gen = torch.Generator().manual_seed(3)
    X = torch.rand((48, cfg["D"]), generator=gen, dtype=torch.float64) * 6 - 3
    if cfg["likelihood"]["kind"] == "MultiClass":
        Y = torch.randint(0, cfg["K"], (48, 1), generator=gen).double()
    else:
        Y = torch.randn((48, 1), generator=gen, dtype=torch.float64)
    # The program draws its noise in its own dtype (float32 on the card);
    # here both sides take the reference's draws, and the f32 jitter floor.
    z, u = _plain.noise(torch.Generator().manual_seed(11), cfg, 48,
                        torch.float64)
    with pt.config_context(jitter=cfg["jitter"]):
        data = model.E_log_p_Y_from_noise(X, Y, z, -torch.log(-torch.log(u)))
        kl = model.pred_layer.prior_kl() + model.assign_layer.prior_kl()
        port_loss = -(data.mean() - kl / cfg["num_data"])
    port_loss.backward()
    p = {k: t.double().requires_grad_(True) for k, t in state.items()}
    with _plain.Precision("reference") as prec:
        ref_loss = cell.reference().loss(p, cfg, X, Y, z, u, prec)
    ref_loss.backward()
    assert float(port_loss) == pytest.approx(float(ref_loss), rel=1e-10)
    for k, param in model.named_parameters():
        torch.testing.assert_close(param.grad, p[k].grad, rtol=1e-7,
                                   atol=1e-9 * float(p[k].grad.abs().max()))


def test_served_outputs():
    from modulatedgps_tpu_torch import precompute_smgp
    cell = tiny_cell("smgp.serve_grid")
    model, state = _port_and_state(cell)
    served = precompute_smgp(model)
    pool = request_pool(cell.traffic, cell.config, 7, CPU)
    X, Y = (t.double() for t in pool.request(0))
    with torch.no_grad():
        mean, var = served.predict_y(X)
        got = {"mean": mean[0], "var": var[0],
               "assign": served.predict_assign(X),
               "density": served.predict_density(X, Y)}
    want = _plain.serve_outputs(cell.reference().predict, cell.config, state,
                                [(X, Y)], _plain.Precision("reference"))[0]
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=1e-9, atol=1e-11)


def test_train_readings_follow_adam():
    """Three steps of the reference's own Adam from a state move every leaf
    and give finite losses; the same inputs give the same readings."""
    cell = tiny_cell("smgp.train")
    state = st.make_state(cell.config, 2, CPU)
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.rand((32, 4), generator=gen) * 6 - 3,
                torch.randn((32, 1), generator=gen)) for _ in range(3)]
    a, b = (_plain.train_readings(cell.reference().loss, cell.config, state,
                                  batches, 9, 3, _plain.Precision("reference"))
            for _ in range(2))
    assert a == b
    assert all(v > 0 for v in a["change_norms"].values())
