"""Training: the FPGA-aware vision front end (float pre-training with BN,
BN fusion, QAT with online quantization, checkpoint/restart, export)."""
