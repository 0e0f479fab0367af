"""--arch gemma3-27b (thin re-export; table of shape cells in lm.py)."""
from .lm import gemma3_27b as config          # full assigned config
from .registry import get as _get

ARCH_ID = "gemma3-27b"


def reduced():
    return _get(ARCH_ID).make_reduced()


def cells():
    return _get(ARCH_ID).cells
