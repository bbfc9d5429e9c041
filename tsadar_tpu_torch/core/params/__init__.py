from .distributions import DLM1V, Maxwellian1V, velocity_grid
from .ts_params import ThomsonParams, get_filter_spec

__all__ = ["DLM1V", "Maxwellian1V", "ThomsonParams", "get_filter_spec", "velocity_grid"]
