"""The q_sqrt ring of modulatedgps_tpu_torch.parallel.inducing (``_quad_ring``)
on gloo ranks on the CPU, in float64, at P = 1, 2 and 4 (no JAX).

Every group of P ranks holds the same seeded problem: a raw q_sqrt
[K, M, M], whose column block r rank r masks by the global lower triangle,
and A [M, P * N] of which rank r holds the batch columns r.  Each rank
takes the backward of sum(w_r * ring_r), its share of the global scalar.
Against the dense formula sum_p (tril(Lq)[:, :, p]^T a_n)^2 computed whole
in one process (rtol 1e-12):

- the ring's value on every rank's columns;
- its gradients with respect to the raw block (through the mask) and to
  A's columns.

And on the ranks themselves:

- each turn's forward product reduces over M - j M / P rows, j the owner of
  the block the rank holds at that turn, and the pullback's two products
  of that turn take the same rows;
- the ring sends what the ring of full products sends (kept below as
  ``_full_ring``, the plain autograd ring the triangle-aware one replaced):
  the same tensors' shapes and bytes, as many, in the same order, forward
  and pullback; the full ring's values and gradients agree as well.
"""
import zlib

import pytest
import torch
import torch.distributed as dist

from test_torch_parallel_collectives import (load_ranks, record_collectives,
                                             run_ranks, save_rank)

M, K, N = 16, 2, 3
GROUPS = {1: [(0,), (1,), (2,), (3,)], 2: [(0, 1), (2, 3)], 4: [(0, 1, 2, 3)]}


def _problem(P):
    """(raw q_sqrt [K, M, M], A [M, P N], w [K, P N]), seeded by P."""
    g = torch.Generator().manual_seed(zlib.crc32(f"ring {P}".encode()))
    raw = torch.randn((K, M, M), generator=g, dtype=torch.float64)
    A = torch.randn((M, P * N), generator=g, dtype=torch.float64)
    w = torch.randn((K, P * N), generator=g, dtype=torch.float64)
    return raw, A, w


def _mask_cols(cols):
    return (torch.arange(M)[:, None] >= torch.arange(M)[None, cols]).double()


def _full_ring(Lq_loc, A_loc, *, group, nshards):
    """The ring of full products: at each turn the whole visiting block,
    rows above its columns' diagonal included, autograd through
    collectives.ppermute."""
    from modulatedgps_tpu_torch.parallel.collectives import ppermute, ring_perm
    Kq, Mq, rpd = Lq_loc.shape
    extra = A_loc.new_zeros((Kq, A_loc.shape[1]))
    blk = Lq_loc
    for s in range(nshards):
        lta = blk.transpose(1, 2).reshape(Kq * rpd, Mq) @ A_loc
        extra = extra + lta.square().reshape(Kq, rpd, -1).sum(1)
        if s < nshards - 1:
            blk = ppermute(blk, group, ring_perm(nshards))
    return extra


def _products():
    """A dispatch mode recording the shapes of every aten mm / addmm."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("mm", "addmm", "addmm_"):
                self.calls.append((name, [tuple(a.shape) for a in args
                                          if isinstance(a, torch.Tensor)]))
            return func(*args, **(kwargs or {}))

    return Products()


def _run(ring, raw, A, w, r, P, group, **kw):
    rpd = M // P
    cols = slice(r * rpd, (r + 1) * rpd)
    blk = raw[:, :, cols].clone().requires_grad_(True)
    A_loc = A[:, r * N:(r + 1) * N].clone().requires_grad_(True)
    mask = _mask_cols(cols)
    fwd, bwd = _products(), _products()
    with record_collectives() as sends:
        with fwd:
            extra = ring(blk * mask, A_loc, group=group, nshards=P, **kw)
        with bwd:
            (w[:, r * N:(r + 1) * N] * extra).sum().backward()
    return {"extra": extra.detach(), "d_raw": blk.grad, "d_A": A_loc.grad,
            "sends": list(sends), "fwd": fwd.calls, "bwd": bwd.calls}


def ring_program(rank, world, out_dir):
    from modulatedgps_tpu_torch.parallel.inducing import _quad_ring
    groups = {P: [dist.new_group(list(ranks)) for ranks in sets]
              for P, sets in GROUPS.items()}
    results = {}
    for P, sets in GROUPS.items():
        for ranks, group in zip(sets, groups[P]):
            if rank not in ranks:
                continue
            r = ranks.index(rank)
            raw, A, w = _problem(P)
            results[P] = {"r": r,
                          "ring": _run(_quad_ring, raw, A, w, r, P, group,
                                       index=r),
                          "full": _run(_full_ring, raw, A, w, r, P, group)}
    save_rank(out_dir, rank, results)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_ring")
    run_ranks(ring_program, tmp, str(tmp))
    return load_ranks(tmp)


def _dense(P):
    """(extra [K, P N], d raw [K, M, M], d A [M, P N]) of the dense formula
    in one process."""
    raw, A, w = _problem(P)
    raw.requires_grad_(True)
    A.requires_grad_(True)
    L = raw * _mask_cols(slice(0, M))
    extra = (L.transpose(1, 2) @ A).square().sum(1)
    (w * extra).sum().backward()
    return extra.detach(), raw.grad, A.grad


def _rows(r, P, s):
    """The rows of the block rank r holds at turn s: M - j M / P."""
    return M - (r - s) % P * (M // P)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("P", sorted(GROUPS))
def test_ring_value_matches_the_dense_formula(ranks, P):
    extra, _, _ = _dense(P)
    for res in ranks:
        r = res[P]["r"]
        for kind in ("ring", "full"):
            _close(res[P][kind]["extra"], extra[:, r * N:(r + 1) * N])


@pytest.mark.parametrize("P", sorted(GROUPS))
def test_ring_gradients_match_the_dense_formula(ranks, P):
    _, d_raw, d_A = _dense(P)
    rpd = M // P
    for res in ranks:
        r = res[P]["r"]
        for kind in ("ring", "full"):
            got = res[P][kind]
            _close(got["d_raw"], d_raw[:, :, r * rpd:(r + 1) * rpd])
            _close(got["d_A"], d_A[:, r * N:(r + 1) * N])


@pytest.mark.parametrize("P", sorted(GROUPS))
def test_each_turn_reduces_over_the_blocks_rows(ranks, P):
    """Turn s's one product is [K M / P, m] @ [m, N], m = M - j M / P."""
    rpd = M // P
    for res in ranks:
        r = res[P]["r"]
        want = [[(K * rpd, _rows(r, P, s)), (_rows(r, P, s), N)]
                for s in range(P)]
        assert [shapes for name, shapes in res[P]["ring"]["fwd"]
                if name == "mm"] == want
        assert len(res[P]["ring"]["fwd"]) == P


@pytest.mark.parametrize("P", sorted(GROUPS))
def test_pullback_products_take_the_blocks_rows(ranks, P):
    """Last turn first: the block's cotangent [K M / P, N] @ [N, m] and
    A's rows dA[r0:] += [m, K M / P] @ [K M / P, N]."""
    rpd = M // P
    for res in ranks:
        r = res[P]["r"]
        want = []
        for s in reversed(range(P)):
            m = _rows(r, P, s)
            want += [("mm", [(K * rpd, N), (N, m)]),
                     ("addmm_", [(m, N), (m, K * rpd), (K * rpd, N)])]
        assert res[P]["ring"]["bwd"] == want


@pytest.mark.parametrize("P", sorted(GROUPS))
def test_sends_are_the_full_rings(ranks, P):
    """P - 1 whole [K, M, M / P] blocks each way, as the full ring sent."""
    block = (K, M, M // P)
    for res in ranks:
        sends = res[P]["ring"]["sends"]
        assert sends == res[P]["full"]["sends"]
        assert sends == [("send", block, 8 * K * M * (M // P))] * (
            2 * (P - 1))
