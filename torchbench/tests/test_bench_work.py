"""The work counts from shapes against a count by hand at a small size."""
import json

import pytest

from conftest import ROOT
from torchbench.harness import peaks
from torchbench.work import _count

CONFIGS = ["smgp_gauss_k8_m4096", "smgpmod_multiclass_k8_m4096"]


def small(name, M=4, K=2, D=1, S=3):
    cfg = json.loads((ROOT / "torchbench" / "configs" / f"{name}.json").read_text())
    return dict(cfg, M=M, K=K, D=D, S=S)


def test_layer_by_hand():
    # M=4, K=2, D=1, N=3: Kmm's 10 entries and Kmn's 12 at 5 FLOPs each;
    # chol 64/3; the solve 4*5*3 = 60; |A|^2 24; A^T q_mu 48; the tril
    # products 2*3*4*5 = 120 and their squares 48; the KL 2*2*10 + 16.
    want = 5 * 22 + 64 / 3 + 60 + 24 + 48 + 120 + 48 + 56
    assert _count.layer_forward_flops(4, 2, 1, 3) == pytest.approx(want)
    # served: no Kmm, no factor, no KL
    assert _count.layer_served_flops(4, 2, 1, 3) == pytest.approx(
        5 * 12 + 60 + 24 + 48 + 120 + 48)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_by_hand(name):
    cfg = small(name)
    layer = 5 * 22 + 64 / 3 + 60 + 24 + 48 + 120 + 48 + 56
    if cfg["model"] == "SMGP":       # Gaussian VE; one W
        lik = 8 * 3 * 2 + 12 * 3 * 3 * 2 + 4 * 3 * 3
        params = 2 * (2 * 10 + 8 + 4 + 2) + 2
    else:                            # RobustMax over 20 nodes, Gaussian on A
        lik = 22 * 3 * 2 * 20 + 8 * 3 * 2 + 2 * (12 * 3 * 3 * 2 + 4 * 3 * 3)
        params = 2 * (2 * 10 + 8 + 4 + 2) + 2
    got = _count.train_step(cfg, 3)
    assert got["flops"] == pytest.approx(3 * (2 * layer + lik) + 12 * params)
    assert got["bytes"] == 28 * params + 3 * 2 * 4


def test_request_by_hand():
    # the prediction layer's marginals; the assignment layer's mean alone:
    # Kmn's 12 entries at 5 FLOPs and Kmn^T q_mu 48; its cache Z and q_mu
    cfg = small("smgp_gauss_k8_m4096")
    served = ((5 * 12 + 60 + 24 + 48 + 120 + 48) + (5 * 12 + 48)
              + 8 * 3 * 2 + 16 * 3 * 2)
    cache = (10 * 4 + 2 * 10 * 2 + 4 * 4 + 8 * 4) + (4 * 4 + 8 * 4)
    got = _count.request(cfg, 3)
    assert got == {"flops": served, "bytes": cache + 3 * 2 * 4 + 3 * 7 * 4}


def test_least_time_is_the_larger_bound():
    w = {"flops": 989e12, "bytes": 3.35e12 / 2}
    assert peaks.least_seconds(w) == pytest.approx(1.0)
    assert peaks.least_seconds({"flops": 0, "bytes": 3.35e12}) == 1.0
