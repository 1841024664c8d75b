"""PyTorch/CUDA port of the DeepDive reproduction (see `src/repro/`, the
JAX reference it is held against). Integer MobileNetV2 / compact-EfficientNet
inference from a `.qnet` artifact, partitioned into CU stages and served by
`serve.vision.VisionEngine`, with the pointwise, depthwise and fused-IRB
kernels written by hand in CUDA for Hopper; and the kernel ops' LM entry
points (`kernels.ops.quantized_linear`, `decode_attend`) over hand-written
weight-only quantized matmul and decode-attention kernels."""
