"""--arch llama4-maverick-400b-a17b (thin re-export; table of shape cells in lm.py)."""
from .lm import llama4_maverick as config          # full assigned config
from .registry import get as _get

ARCH_ID = "llama4-maverick-400b-a17b"


def reduced():
    return _get(ARCH_ID).make_reduced()


def cells():
    return _get(ARCH_ID).cells
