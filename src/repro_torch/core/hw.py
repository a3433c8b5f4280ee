"""Hardware constants: the port's target card and the paper's platform.

NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no sparsity, at the
full 700 W power limit).  These are data-sheet figures, not measurements:
they price the analytic cost model and the roofline bounds that
``chip_smoke.py`` prints beside each kernel's measured time.

Intel Knights Landing / Xeon Phi 7210 (the paper's evaluation platform,
published figures): 64 cores, 6 TFLOP/s fp32 aggregate, MCDRAM up to
400 GB/s, 16 GB.  They price only the paper-reproduction simulator.
"""

# --- NVIDIA H100 SXM (data sheet) ---
H100_PEAK_FLOPS = 989e12       # dense bf16 tensor-core FLOP/s
H100_HBM_BW = 3.35e12          # HBM3 bytes/s
H100_HBM_GB = 80.0
H100_FP32_FLOPS = 67e12        # float32 FLOP/s outside the tensor cores
H100_NVLINK_BW = 900e9         # NVLink 4 bytes/s to the host's other cards

# --- The paper's Intel Knights Landing (Xeon Phi 7210) ---
# Published figures of the paper's evaluation platform, NOT of the H100
# (and not of any TPU): the fluid simulator that reproduces the paper's
# Fig. 4/5/6 (``core.shaping_sim.simulate``, ``core.schedule``) is priced
# with them, so its numbers equal the reference's exactly.
KNL_CORES = 64
KNL_PEAK_FLOPS = 6e12          # fp32 aggregate
KNL_FLOPS_PER_CORE = KNL_PEAK_FLOPS / KNL_CORES
KNL_MEM_BW = 400e9             # MCDRAM bytes/s
KNL_MEM_GB = 16.0
KNL_LLC_BYTES = 32e6           # aggregate L2
