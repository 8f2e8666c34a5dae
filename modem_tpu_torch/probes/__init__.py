"""The TPU kernel probes of ``bench/`` rewritten for the card: D
(``p256``, bench/probe_p256.py), E (``rank3``, bench/probe_rank3.py) and
F (``interleave``, bench/probe_interleave.py).  Each module holds a CUDA
kernel (csrc/probe_*.cu), its plain PyTorch twin and the probe's command
line: ``python3 -m modem_tpu_torch.probes.<name>``."""
