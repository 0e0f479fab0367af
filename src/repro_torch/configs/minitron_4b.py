"""--arch minitron-4b (thin re-export; table of shape cells in lm.py)."""
from .lm import minitron_4b as config          # full assigned config
from .registry import get as _get

ARCH_ID = "minitron-4b"


def reduced():
    return _get(ARCH_ID).make_reduced()


def cells():
    return _get(ARCH_ID).cells
