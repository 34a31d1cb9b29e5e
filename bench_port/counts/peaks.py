"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit; a card set below it
runs slower under load, so every run prints the card's name and limit
beside its numbers)."""

BF16_DENSE_FLOPS_PER_S = 989e12   # tensor cores, bf16 and fp16
TF32_DENSE_FLOPS_PER_S = 494.7e12  # tensor cores, TF32
F32_FLOPS_PER_S = 67e12           # CUDA cores, float32
HBM_BYTES_PER_S = 3.35e12         # 80 GB of HBM3
