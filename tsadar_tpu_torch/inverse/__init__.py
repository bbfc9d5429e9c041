from .loops import _1d_adam_loop_, _angular_loop_, angular_optax, one_d_loop
from .loss import LossFunction

__all__ = ["LossFunction", "angular_optax", "one_d_loop", "_1d_adam_loop_", "_angular_loop_"]
