from .loops import _1d_adam_loop_, one_d_loop
from .loss import LossFunction

__all__ = ["LossFunction", "one_d_loop", "_1d_adam_loop_"]
