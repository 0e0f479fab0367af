"""--arch dimenet (thin re-export; table of shape cells in gnn.py)."""
from .gnn import dimenet as config          # full assigned config
from .registry import get as _get

ARCH_ID = "dimenet"


def reduced():
    return _get(ARCH_ID).make_reduced()


def cells():
    return _get(ARCH_ID).cells
