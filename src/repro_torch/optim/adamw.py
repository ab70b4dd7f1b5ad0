"""AdamW, gradient clipping and the cosine schedule (port of
``repro.optim.adamw``): leaf-wise tensor ops over parameter trees.

The moments' dtype follows the reference's rule (``_sdt``): the parameter's
dtype promoted to f32 unless ``state_dtype`` names one (bf16 moments for
the >= 300B configs).  Every update is computed in f32 and cast back to
the parameter's and the moments' dtypes.  ``update(..., donate=True)``
writes the results into the given parameter and moment tensors, leaf by
leaf (the reference's buffer donation): the step then holds one leaf's
temporaries beside the state instead of a second copy of all of it.
``clip_by_global_norm`` scales
each leaf in its own dtype, as the reference does, so a bf16 gradient is
not copied to f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.optim.tree import leaves, tree_map, unflatten, zeros_for

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor  # [] int32
    mu: Any  # tree like params
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Optional[str] = None  # None: the param's dtype promoted to f32

    def _sdt(self, p: torch.Tensor) -> torch.dtype:
        if self.state_dtype is not None:
            return _STATE_DTYPES[self.state_dtype]
        return torch.promote_types(p.dtype, torch.float32)

    def init(self, params) -> AdamWState:
        def zeros(p):
            return zeros_for(p, p.shape, self._sdt(p))

        step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
        return AdamWState(step=step, mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr_scale=1.0, donate: bool = False):
        """-> (new params, new state); ``lr_scale`` a float or a 0-d tensor.
        With ``donate`` the new values overwrite ``params`` and ``state``'s
        moments, which are returned."""
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        lr = self.lr * lr_scale

        def upd(g, m, v, p):
            g32, p32 = g.float(), p.float()
            m_new = b1 * m.float() + (1 - b1) * g32
            v_new = b2 * v.float() + (1 - b2) * torch.square(g32)
            delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            delta = delta + self.weight_decay * p32
            p_new = p32 - lr * delta
            out = p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)
            if not donate:
                return out
            for dst, src in zip((p, m, v), out):
                dst.copy_(src)
            return p, m, v

        out = [upd(*t) for t in zip(leaves(grads), leaves(state.mu), leaves(state.nu),
                                    leaves(params))]
        p_new, mu, nu = (unflatten(params, [o[i] for o in out]) for i in range(3))
        return p_new, AdamWState(step=step, mu=mu, nu=nu)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """-> (tree scaled so its global norm is at most ``max_norm``, the norm
    before clipping); each leaf scaled in its own dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def cosine_schedule(step, base_lr: float, warmup: int, total: int, min_frac=0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from ``base_lr``
    down to ``min_frac * base_lr`` at ``total`` -> an f32 0-d tensor."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
