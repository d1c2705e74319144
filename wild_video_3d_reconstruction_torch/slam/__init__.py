from .dpvo import DPVO
