"""PyTorch/CUDA port of the DeepDive reproduction (see `src/repro/`, the
JAX reference it is held against). This slice: integer MobileNetV2 /
compact-EfficientNet inference from a `.qnet` artifact, partitioned into CU
stages and served by `serve.vision.VisionEngine`, with the pointwise,
depthwise and fused-IRB kernels written by hand in CUDA for Hopper."""
