"""The benchmark of eddy_currents_3d_tpu_torch on one CUDA card: whole
transients of implicit steps, timed end to end (``run.py``)."""
