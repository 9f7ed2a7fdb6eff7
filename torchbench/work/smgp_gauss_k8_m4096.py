"""The work of one training step and one served request of smgp_gauss_k8_m4096,
from its shapes (see _count for what counts)."""
from torchbench.work import _count


def train_step(cfg: dict, batch: int) -> dict:
    return _count.train_step(cfg, batch)


def request(cfg: dict, n: int) -> dict:
    return _count.request(cfg, n)
