"""Distribution: meshes of devices, logical-axis placement rules, data-
parallel replicas and pipeline parallelism, driven by one process.

Counterpart of `repro/dist/`. Everything degrades to a single-device
no-op, so the same code runs on one card, on several, and on the CPU."""
