"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Roofline and MFU shares
are stated against these, with the card's power limit printed beside."""

BF16_FLOPS = 989e12  # tensor cores, bfloat16 / float16
FP32_FLOPS = 67e12  # CUDA cores, float32 (an FMA counted as 2)
HBM_BYTES_PER_S = 3.35e12
