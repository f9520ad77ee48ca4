"""Limits of the card that the launch plans (``lora_matmul/plan.py``,
``flash_attention/plan.py``, ``ssd_scan/plan.py``) share."""

SMS = 132               # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8         # blocks of one thread-block cluster (the portable limit)
