"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit): what every roofline share and every `mfu` is
stated against."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12            # CUDA cores, no tensor cores
BF16_FLOPS = 989e12          # tensor cores, dense
