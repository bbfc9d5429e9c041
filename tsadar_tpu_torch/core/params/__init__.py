from .distributions import DLM1V, Arbitrary2V, Maxwellian1V, velocity_grid
from .spherical import SphericalHarmonics
from .ts_params import ThomsonParams, get_filter_spec, ravel_order

__all__ = ["DLM1V", "Arbitrary2V", "Maxwellian1V", "SphericalHarmonics", "ThomsonParams", "get_filter_spec", "ravel_order", "velocity_grid"]
