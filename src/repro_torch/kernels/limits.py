"""Limits of the card: what the launch plans (``lora_matmul/plan.py``,
``flash_attention/plan.py``, ``ssd_scan/plan.py``) share, and the rates
that bound a kernel (``chip_smoke.py``'s bounds) or a whole step
(``analysis.roofline``).

The rates are those of an NVIDIA H100 SXM5 80GB at its 700 W limit, from
NVIDIA's H100 Tensor Core GPU datasheet (dense rates, without sparsity):
a card held below 700 W runs slower under load.
"""

SMS = 132               # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8         # blocks of one thread-block cluster (the portable limit)

HBM_BYTES_PER_S = 3.35e12          # HBM3, datasheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate, datasheet
              "tf32": 495e12,      # dense tensor-core rate, datasheet
              "float32": 67e12}    # outside the tensor cores, datasheet
NVLINK_BYTES_PER_S = 450e9         # NVLink 4: 900 GB/s a card, 450 each direction
NODE_CARDS = 8                     # cards of one node (HGX H100 8-GPU), all NVLink-joined
NETWORK_BYTES_PER_S = 50e9         # 400 Gb/s NDR InfiniBand, one port a card
