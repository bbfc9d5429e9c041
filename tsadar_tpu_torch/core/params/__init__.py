from .distributions import DLM1V, Maxwellian1V, velocity_grid
from .ts_params import ThomsonParams

__all__ = ["DLM1V", "Maxwellian1V", "ThomsonParams", "velocity_grid"]
