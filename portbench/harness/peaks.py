"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit). The port computes in float32 with TF32 off, so its
peak is float32 outside the tensor cores."""

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
