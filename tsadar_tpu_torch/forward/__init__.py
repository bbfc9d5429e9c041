"""Forward and series spectra (``calc_series.forward_pass``)."""
