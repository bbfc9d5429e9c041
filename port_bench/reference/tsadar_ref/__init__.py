"""A frozen copy of the port's plain PyTorch physics and data pipeline: the benchmark's reference.

Copied from ``tsadar_tpu_torch`` (its ``core``, ``inverse/loss.py``,
``device.py`` and the data pipeline of ``utils``) and changed only where the
port would reach a kernel, a figure, the feature detector or another rank:
every lookup, the pole tables and the spectrum tail take their plain forms
on any device and in any dtype (``core/physics/interp.plain_forms_on`` is
always true, ``ops_plain.py`` holds the kernels' plain forms), the data
pipeline draws no figure and refuses the detector, ``parallel/dist.py``
is one process, and in bfloat16 (the correctness check's control) the
instrument's FFT convolution runs in float32 and rounds its result back.  It imports nothing of the port, and a change to the port
does not reach it.
"""
