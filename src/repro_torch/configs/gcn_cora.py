"""--arch gcn-cora (thin re-export; table of shape cells in gnn.py)."""
from .gnn import gcn_cora as config          # full assigned config
from .registry import get as _get

ARCH_ID = "gcn-cora"


def reduced():
    return _get(ARCH_ID).make_reduced()


def cells():
    return _get(ARCH_ID).cells
