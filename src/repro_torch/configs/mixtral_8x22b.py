"""--arch mixtral-8x22b (thin re-export; table of shape cells in lm.py)."""
from .lm import mixtral_8x22b as config          # full assigned config
from .registry import get as _get

ARCH_ID = "mixtral-8x22b"


def reduced():
    return _get(ARCH_ID).make_reduced()


def cells():
    return _get(ARCH_ID).cells
