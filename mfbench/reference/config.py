"""KITTI class name -> training id; negative ids are ignore / neighbour
classes (reference: config/__init__.py:3-14 of the MonoFlex repository)."""

TYPE_ID_CONVERSION = {
    "Car": 0,
    "Pedestrian": 1,
    "Cyclist": 2,
    "Van": -4,
    "Truck": -4,
    "Person_sitting": -2,
    "Tram": -99,
    "Misc": -99,
    "DontCare": -1,
}


class Config(dict):
    """A configuration tree read from a benchmark configuration file:
    attribute access, lists frozen to tuples (as the program's config
    nodes hold them)."""

    def __init__(self, tree: dict):
        super().__init__({k: Config(v) if isinstance(v, dict) else _freeze(v)
                          for k, v in tree.items()})

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def _freeze(v):
    return tuple(_freeze(x) for x in v) if isinstance(v, list) else v
