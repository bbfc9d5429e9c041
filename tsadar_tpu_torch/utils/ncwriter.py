"""netCDF3 datasets on ``scipy.io.netcdf_file``, a copy of ``tsadar_tpu.utils.ncwriter``.

The binary artifacts of a run (fitted and simulated spectra, sigmas) are
written as a Dataset of same-shaped variables over named 1-D coordinates, as
xarray would write them: xarray, netCDF4 and scipy all read netCDF3 classic,
and the JAX package's files and the port's read alike.
"""

import numpy as np
from scipy.io import netcdf_file


def write_dataset(path, variables, coords):
    """Write ``variables`` (name -> ndarray) over named ``coords`` to netCDF3.

    ``coords`` is a sequence of ``(dim_name, 1-D values)`` pairs in the order
    of the variables' axes (xarray's ``coords=`` convention); every variable
    must have one axis per coordinate.
    """
    coords = [(str(name), np.asarray(vals).ravel()) for name, vals in coords]
    dims = tuple(name for name, _ in coords)

    f = netcdf_file(path, "w")
    try:
        for name, vals in coords:
            f.createDimension(name, len(vals))
            var = f.createVariable(name, "f8", (name,))
            var[:] = np.asarray(vals, np.float64)
        for name, arr in variables.items():
            arr = np.asarray(arr, np.float64)
            expected = tuple(len(vals) for _, vals in coords)
            if arr.shape != expected:
                raise ValueError(f"variable {name!r} has shape {arr.shape}, expected {expected} from coords {dims}")
            var = f.createVariable(str(name), "f8", dims)
            var[:] = arr
    finally:
        f.close()


def read_dataset(path):
    """Read back a netCDF3 file as (variables dict, coords dict) of ndarrays."""
    f = netcdf_file(path, "r", mmap=False)
    try:
        dims = set(f.dimensions)
        coords = {k: np.array(v[:]) for k, v in f.variables.items() if k in dims}
        variables = {k: np.array(v[:]) for k, v in f.variables.items() if k not in dims}
        return variables, coords
    finally:
        f.close()
