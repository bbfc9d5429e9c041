"""The plain reference of the benchmark's correctness check (``fits.py`` over the frozen copy ``tsadar_ref``)."""
