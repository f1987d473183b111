"""Gradient clipping — port of ``paddle_tpu/nn/clip.py`` (``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``,
``clip_grad_value_``) with the math of the JAX
package's traced form ``_pure_grad_clip`` (``optimizer/optimizer.py``).

A clip object is called on ``[(param, grad), ...]`` and scales the grads
IN PLACE (returning the same list): squared norms are taken in fp32, the
scale ``min(clip_norm / max(norm, 1e-12), 1)`` stays a device scalar (no
host sync), and each grad is multiplied in fp32 and rounded back to its
own dtype.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        with torch.no_grad():
            self._clip([g for _, g in params_grads if g is not None])
        return params_grads

    def _clip(self, grads):
        raise NotImplementedError


def _sq_norm(g):
    return torch.linalg.vector_norm(g, dtype=torch.float32).square()


def _scale_(g, scale):
    g.copy_(g.float() * scale)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def _clip(self, grads):
        for g in grads:
            g.clamp_(self.min, self.max)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, grads):
        for g in grads:
            nrm = _sq_norm(g).sqrt()
            _scale_(g, torch.clamp(self.clip_norm / nrm.clamp_min(1e-12),
                                   max=1.0))


class ClipGradByGlobalNorm(ClipGradBase):
    """One norm over every gradient; ``group_name`` and
    ``auto_skip_clip`` are accepted for API parity and unused, as in the
    JAX package."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def _clip(self, grads):
        if not grads:
            return
        sq = torch.stack([_sq_norm(g) for g in grads]).sum()
        scale = torch.clamp(self.clip_norm / sq.sqrt().clamp_min(1e-12),
                            max=1.0)
        for g in grads:
            _scale_(g, scale)



@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients in place by ``min(max_norm /
    (total + 1e-6), 1)``, total their ``norm_type`` norm (the largest
    |g| for inf, fp32 powers otherwise), as the JAX package does: no host
    read. Returns the total (a 0-d device tensor)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.copy_(g * scale)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp the parameters' gradients to [-clip_value, clip_value], in
    place."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
