"""NVIDIA H100 80GB HBM3 (SXM5, 700 W) constants, one card.

Sources: NVIDIA H100 Tensor Core GPU data sheet (SXM5 column; dense, i.e.
without the 2:4 sparsity factor) and the NVIDIA Hopper architecture
whitepaper. A card set below 700 W runs slower under load; the dry run's
terms assume the full limit.
"""

# NVIDIA H100 80GB HBM3, 700 W: 989.4 TFLOP/s BF16 dense Tensor Core
# (data sheet: 1,979 TFLOP/s "with sparsity", halved)
PEAK_FLOPS_BF16 = 989.4e12  # FLOP/s
# NVIDIA H100 80GB HBM3, 700 W: 66.9 TFLOP/s FP32 (CUDA cores; the data
# sheet's 67 TFLOP/s: 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz boost)
PEAK_FLOPS_F32 = 66.9e12  # FLOP/s
# NVIDIA H100 80GB HBM3, 700 W: 3.35 TB/s HBM3 (data sheet)
HBM_BW = 3.35e12  # bytes/s
# NVIDIA H100 80GB HBM3, 700 W: 80 GB HBM3 (data sheet)
HBM_BYTES = 80e9  # bytes
# NVIDIA H100 80GB HBM3, 700 W: 33.5 T instructions/s (warp lanes a cycle)
# for the min-plus products, which no Tensor Core computes (132 SMs x 4
# schedulers x 32 lanes x 1.98 GHz; the bound of chip_smoke.py)
INSTR_RATE = 33.5e12  # instructions/s
# NVIDIA H100 80GB HBM3, 700 W: the link the collective term divides by.
# A 16-wide mesh axis spans nodes (8 cards a node), so its ring runs at
# the per-card network rate: one 400 Gb/s ConnectX-7 NIC a card = 50 GB/s
# a direction (DGX H100 system guide). Within a node NVLink 4 gives 450
# GB/s a direction (data sheet: 900 GB/s bidirectional); it is not used,
# since the slowest hop of a cross-node ring sets its rate.
NET_BW_PER_CARD = 50e9  # bytes/s, one direction
NVLINK_BW = 450e9  # bytes/s, one direction (within a node; not used)
