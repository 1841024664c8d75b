"""The full-width streaming workloads of the port, in numpy alone: shared by
`tests/test_torch_stream.py` (which also regenerates their fixtures with
the JAX package), `tests/test_torch_cuda.py` and `chip_smoke.py`.

  * KWS: `build_kws()` at its defaults, the Hello-Edge DS-CNN-S widths
    (window 49 frames x 10 MFCC, stem Conv1d k5/s2, 64 channels, 4 DS
    blocks k3, tail 128, 12 classes), act8/w8; hop 4 frames (80 ms at the
    20 ms frame stride); 64 sessions of 16 windows each.
  * HAR: `build_har()` at its defaults (window 128 x 3, stem 48 channels,
    DS blocks 96/128/160 with stride-2 DW k5), act8/w8; hop 16; 8 sessions
    of 8 windows each.

Each net is `make_calibrated_qnet(net, bits=8, seed=0)`, frozen in
`tests/golden_torch/<name>.qnet`; `<name>.npz` holds the JAX package's
`cu.run_qnet` logits over every session's windows (`logits_float`, and
for KWS `logits_fixed`, computed under a scoped `jax.enable_x64(True)`),
[sessions * windows, classes] in session-major order. The frames are not
stored: `frames(case)` regenerates them from their seed.
"""
import os

import numpy as np

GOLDEN_TORCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "golden_torch")

CASES = {
    "kws": dict(name="dscnn_kws_t49_c64_act8",
                build={"model": "dscnn_kws", "bits": 8},
                window=49, input_ch=10, hop=4, sessions=64, windows=16,
                seed=1, fixed=True),
    "har": dict(name="dscnn_har_t128_act8",
                build={"model": "dscnn_har", "bits": 8},
                window=128, input_ch=3, hop=16, sessions=8, windows=8,
                seed=2, fixed=False),
}
BUCKETS = (2, 4, 8, 16, 32, 64)


def paths(case: str):
    base = os.path.join(GOLDEN_TORCH, CASES[case]["name"])
    return base + ".qnet", base + ".npz"


def stream_len(case: str) -> int:
    c = CASES[case]
    return c["window"] + (c["windows"] - 1) * c["hop"]


def frames(case: str) -> np.ndarray:
    """[sessions, stream_len, input_ch] float32 in [-1, 1], the calibrated
    input range."""
    c = CASES[case]
    return np.random.default_rng(c["seed"]).uniform(
        -1, 1, (c["sessions"], stream_len(case), c["input_ch"])).astype(
            np.float32)


def windows(case: str) -> np.ndarray:
    """Every session's hop-aligned windows, [sessions * windows, window,
    input_ch], session-major: the rows the fixture's logits answer."""
    c = CASES[case]
    f = frames(case)
    return np.stack([f[s, i * c["hop"]:i * c["hop"] + c["window"]]
                     for s in range(c["sessions"])
                     for i in range(c["windows"])])
