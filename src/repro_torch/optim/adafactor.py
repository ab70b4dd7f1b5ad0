"""Adafactor (Shazeer & Stern, arXiv:1804.04235): factored second moments
(port of ``repro.optim.adafactor``).

A leaf of two or more dims keeps per-row and per-column second-moment
factors over its trailing two dims (leading dims, a layer stack or an
expert axis, stay unfactored) and no first moment; a vector keeps its full
second moment.  The update is RMS-clipped to ``clip_threshold``.

The reference's quirk is kept: a leaf of ndim >= 3 with more than
``CHUNK_ELEMS`` (32M) elements is updated one leading-axis slice at a time
(its scan bounds f32 temporaries to one slice), so its RMS clip is taken
per slice, not over the whole leaf.  ``update(..., donate=True)`` writes
the results into the given parameter and factor tensors (the reference's
buffer donation), leaf by leaf and slice by slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.optim.tree import leaves, tree_map, unflatten, zeros_for

CHUNK_ELEMS = 32 * 1024 * 1024


class AdafactorState(NamedTuple):
    step: torch.Tensor  # [] int32
    v_row: Any  # tree: [.., rows] for ndim >= 2 leaves, zeros [1] otherwise
    v_col: Any  # tree: [.., cols]
    v_full: Any  # tree: the full v for ndim < 2 leaves, zeros [1] otherwise


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-2
    decay_pow: float = 0.8
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    @staticmethod
    def _factored(p) -> bool:
        return p.ndim >= 2

    def init(self, params) -> AdafactorState:
        def zeros(shape, p):
            return zeros_for(p, shape, torch.float32)

        def vr(p):
            return zeros(p.shape[:-1] if self._factored(p) else (1,), p)

        def vc(p):
            return zeros(p.shape[:-2] + p.shape[-1:] if self._factored(p) else (1,), p)

        def vf(p):
            return zeros((1,) if self._factored(p) else p.shape, p)

        step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
        return AdafactorState(step=step, v_row=tree_map(vr, params), v_col=tree_map(vc, params),
                              v_full=tree_map(vf, params))

    def _update_leaf(self, g, vr, vc, vf, p, decay, lr):
        """One leaf (or one slice of a big one) -> (p, v_row, v_col, v_full)."""
        g32 = g.float()
        g2 = torch.square(g32) + self.eps1
        if self._factored(p):
            vr_new = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
            vc_new = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
            vf_new = vf
            denom_r = torch.mean(vr_new, dim=-1, keepdim=True)
            vhat = (vr_new / torch.clamp(denom_r, min=self.eps1))[..., None] * vc_new[..., None, :]
            u = g32 * torch.rsqrt(torch.clamp(vhat, min=self.eps1))
        else:
            vr_new, vc_new = vr, vc
            vf_new = decay * vf + (1 - decay) * g2
            u = g32 * torch.rsqrt(torch.clamp(vf_new, min=self.eps1))
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + self.eps1)
        u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
        p_new = p.float() - lr * u
        if self.weight_decay:
            p_new = p_new - lr * self.weight_decay * p.float()
        return p_new.to(p.dtype), vr_new, vc_new, vf_new

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params, lr_scale=1.0, donate: bool = False):
        """-> (new params, new state); with ``donate`` the new values
        overwrite ``params`` and ``state``'s factors, which are returned."""
        step = state.step + 1
        decay = 1.0 - torch.pow(step.float(), -self.decay_pow)
        lr = self.lr * lr_scale

        def one(g, vr, vc, vf, p):
            out = self._update_leaf(g, vr, vc, vf, p, decay, lr)
            if not donate:
                return out
            for dst, src in zip((p, vr, vc, vf), out):
                if dst is not src:
                    dst.copy_(src)
            return p, vr, vc, vf

        def leaf(g, vr, vc, vf, p):
            if p.ndim >= 3 and p.numel() > CHUNK_ELEMS and self._factored(p):
                # one leading-axis slice at a time, each clipped on its own
                parts = [one(g[i], vr[i], vc[i], vf, p[i]) for i in range(p.shape[0])]
                if donate:
                    return p, vr, vc, vf
                return (torch.stack([t[0] for t in parts]), torch.stack([t[1] for t in parts]),
                        torch.stack([t[2] for t in parts]), vf)
            return one(g, vr, vc, vf, p)

        out = [leaf(*t) for t in zip(leaves(grads), leaves(state.v_row), leaves(state.v_col),
                                     leaves(state.v_full), leaves(params))]
        p_new, v_row, v_col, v_full = (unflatten(params, [o[i] for o in out]) for i in range(4))
        return p_new, AdafactorState(step=step, v_row=v_row, v_col=v_col, v_full=v_full)
