"""The work of one all-reduce of rank_probe: a ring moves 2 (W - 1) / W
of the share's bytes in and out of each rank, and adds (W - 1) / W of its
entries."""


def all_reduce(cfg: dict, world: int) -> dict:
    share = cfg["M"] * cfg["K"]
    return {"flops": share * (world - 1) / world,
            "bytes": 2 * share * 4 * (world - 1) / world}
