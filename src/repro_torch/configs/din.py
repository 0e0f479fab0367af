"""--arch din (thin re-export; table of shape cells in din_cfg.py)."""
from .din_cfg import din as config          # full assigned config
from .registry import get as _get

ARCH_ID = "din"


def reduced():
    return _get(ARCH_ID).make_reduced()


def cells():
    return _get(ARCH_ID).cells
