"""The plain reference of rank_probe: rank r contributes r + 1 to every
entry, so the all-reduced sum over W ranks is W (W + 1) / 2."""


def total(world: int) -> float:
    return world * (world + 1) / 2
