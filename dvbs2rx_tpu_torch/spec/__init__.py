"""The port's own copy of the DVB-S2/S2X specification core.

Pure numpy/Python: standard constants, code tables and the reference
algorithms the port's modules and its transmitter build on. Each module is
a copy of its namesake in ``dvbs2rx_tpu/spec`` cut to what the port uses;
``tests/test_torch_spec.py`` holds every copy to its original.
"""
