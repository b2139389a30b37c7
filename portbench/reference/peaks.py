"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates at
its 700 W limit, from NVIDIA's data sheet: the ones the rooflines use."""

FP32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3
