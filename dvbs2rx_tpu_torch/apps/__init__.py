"""The port's command-line apps, run as modules:

    python -m dvbs2rx_tpu_torch.apps.dvbs2_tx ...   # TS in -> IQ out
    python -m dvbs2rx_tpu_torch.apps.dvbs2_rx ...   # IQ in -> TS out
    python -m dvbs2rx_tpu_torch.apps.dvbs2_rec ...  # IQ -> SigMF recording

Counterparts of ``apps/dvbs2-tx``, ``apps/dvbs2-rx`` and ``apps/dvbs2-rec``
with the same options, defaults and messages. Each ``main(argv=None)``
returns the exit code; importing a module runs nothing.
"""
