"""The benchmark harness of the port (``port_bench/run.py`` drives it)."""
