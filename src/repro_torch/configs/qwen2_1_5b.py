"""--arch qwen2-1.5b (thin re-export; table of shape cells in lm.py)."""
from .lm import qwen2_1_5b as config          # full assigned config
from .registry import get as _get

ARCH_ID = "qwen2-1.5b"


def reduced():
    return _get(ARCH_ID).make_reduced()


def cells():
    return _get(ARCH_ID).cells
