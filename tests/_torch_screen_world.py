"""Inputs that press on best mode's division screen (the lane kernels of
``repro_torch/kernels/enrich_score/csrc/enrich_score.cu``), shared by the
card tests and the CPU tests of the screen's PyTorch twin.  Not collected."""

import numpy as np
import torch

from repro_torch.core.entropy import binary_entropy

SCREEN_KINDS = ("tie", "ulp", "subnormal", "pp0", "exhausted")


def screen_world(dev, kind, p, f, dtype, seed):
    """Rows, a random [P, 2^F, B, F] table (+inf where a state ran the
    function) and costs that press on the lane kernels' screen: ``tie``
    every function the same delta and cost (exact ties), ``ulp`` the same
    delta and costs -3..3 ulps apart or falling an ulp a function
    (benefits equal or an ulp apart), ``subnormal`` zero and subnormal
    joints, ``pp0`` pred_prob 0 on a third of the objects, ``exhausted``
    every function already run, ``random`` none of these."""
    rng = np.random.default_rng(seed)
    n, q, bins = 517, 3, (10 if f <= 12 else 3)
    pp = rng.uniform(0.02, 0.98, size=(n, p)).astype(np.float32)
    pp[: n // 4] = rng.uniform(1e-6, 1e-4, size=(n // 4, p))  # saturated rows: est clips to 1
    sid = rng.integers(0, 2**f, size=(n, p)).astype(np.int32)
    joint = rng.uniform(0.0, 1.0, size=(q, n)).astype(np.float32)
    ran = ((np.arange(2**f)[:, None] >> np.arange(f)) & 1).astype(bool)
    delta = rng.uniform(-0.5, 0.3, size=(p, 2**f, bins, f)).astype(np.float32)
    if kind in ("tie", "ulp"):
        delta = np.repeat(delta[..., :1], f, axis=-1)
    delta = np.where(ran[None, :, None, :], np.inf, delta).astype(np.float32)
    costs = rng.uniform(0.01, 1.0, size=(p, f)).astype(np.float32)
    if kind == "tie":
        costs[:] = 0.25
    elif kind == "ulp":
        steps = (rng.integers(-3, 4, size=(p, f)) if seed % 2 else
                 -np.tile(np.arange(f), (p, 1)))
        costs = (np.full((p, f), 0.3, np.float32).view(np.int32) + steps).astype(
            np.int32).view(np.float32)
    elif kind == "subnormal":
        joint[0] = 0.0
        joint[1] = rng.uniform(1e-45, 1e-38, size=n)
        joint[2, ::2] = 1e-39
    elif kind == "pp0":
        pp[::3] = 0.0
    elif kind == "exhausted":
        sid[:] = 2**f - 1
    pp_t = torch.from_numpy(pp).to(dev)
    unc = binary_entropy(pp_t)
    return (pp_t.to(dtype), unc.to(dtype), torch.from_numpy(sid).to(dev),
            torch.from_numpy(joint).to(dev).to(dtype), torch.from_numpy(delta).to(dev),
            torch.from_numpy(np.ascontiguousarray(costs)).to(dev))
