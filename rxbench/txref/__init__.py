"""Frozen copy of the port's DVB-S2 transmitter and the specification core
it builds on (``dvbs2rx_tpu_torch/spec``, ``dvbs2rx_tpu_torch/tx``), pure
numpy. The benchmark makes its traffic with it, so the yardstick does not
move when the program's own transmitter does;
``rxbench/tests/test_rxbench_txref.py`` holds it to the port's."""
