"""Hardware constants of the port's target card.

NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no sparsity, at the
full 700 W power limit).  These are data-sheet figures, not measurements:
they price the analytic cost model and the roofline bounds that
``chip_smoke.py`` prints beside each kernel's measured time.
"""

# --- NVIDIA H100 SXM (data sheet) ---
H100_PEAK_FLOPS = 989e12       # dense bf16 tensor-core FLOP/s
H100_HBM_BW = 3.35e12          # HBM3 bytes/s
H100_HBM_GB = 80.0
H100_FP32_FLOPS = 67e12        # float32 FLOP/s outside the tensor cores
