"""One process: the reference runs the step of a single card, so every
cross-process reduction of the program is the identity here."""


def get_world_size() -> int:
    return 1


def global_sum(t):
    return t


def global_max(t):
    return t
