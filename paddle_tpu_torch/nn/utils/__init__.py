"""``paddle.nn.utils`` — port of ``paddle_tpu/nn/utils``: the weight and
spectral reparameterizations (``weight_norm`` / ``remove_weight_norm``,
``spectral_norm``) and ``parameters_to_vector`` /
``vector_to_parameters``.

A reparameterization replaces ``layer.<name>`` by its factors (new
parameters) and recomputes the weight in a forward pre-hook before every
call, as the JAX package does, so autograd trains the factors.
``spectral_norm``'s power-iteration vectors ``<name>_u`` / ``<name>_v``
are buffers updated in place each forward (a CUDA graph replays the
update); their first draw is from the layer's device generator (the JAX
package draws them from its own host generator: carry its state across
to compare)."""
from __future__ import annotations

import torch

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _norm_except(v, dim):
    """L2 norm over every axis but ``dim`` (kept, size 1 elsewhere); over
    all of them when ``dim`` is None."""
    if dim is None:
        return (v * v).sum().sqrt()
    axes = [i for i in range(v.dim()) if i != dim]
    return (v * v).sum(axes, keepdim=True).sqrt()


def _swap_parameter(layer, name, new):
    """Drop ``layer.<name>`` (a parameter) and register ``new`` ({name:
    tensor}) as parameters."""
    if name in layer._parameters:
        del layer._parameters[name]
    for k, t in new.items():
        layer.register_parameter(k, torch.nn.Parameter(t))


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """``w = g · v / ||v||`` (the norm over every axis but ``dim``):
    ``layer.<name>`` becomes the parameters ``<name>_g`` (the norms) and
    ``<name>_v`` (the direction), the weight recomputed before each
    call."""
    w = getattr(layer, name).detach()
    _swap_parameter(layer, name, {f"{name}_g": _norm_except(w, dim).clone(),
                                  f"{name}_v": w.clone()})

    def compute(lay, *args):
        g = getattr(lay, f"{name}_g")
        v = getattr(lay, f"{name}_v")
        setattr(lay, name, v * (g / _norm_except(v, dim)))

    handle = layer.register_forward_pre_hook(compute)
    layer._weight_norm_hook = (handle, name, dim)
    compute(layer)
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    """Fold ``g · v / ||v||`` back into one parameter ``<name>``."""
    handle, nm, dim = layer._weight_norm_hook
    if nm != name:
        raise ValueError(f"weight_norm was applied to {nm!r}, not {name!r}")
    handle.remove()
    with torch.no_grad():
        g = getattr(layer, f"{name}_g")
        v = getattr(layer, f"{name}_v")
        w = v * (g / _norm_except(v, dim))
    delattr(layer, name)
    del layer._parameters[f"{name}_g"]
    del layer._parameters[f"{name}_v"]
    layer.register_parameter(name, torch.nn.Parameter(w))
    del layer._weight_norm_hook
    return layer


def _moved(w, dim):
    return w.movedim(dim, 0).reshape(w.shape[dim], -1)


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1,
                  eps: float = 1e-12, dim: int = None, generator=None):
    """``w / σ_max(w)``, σ from ``n_power_iterations`` of power iteration
    on w as a (w.shape[dim], -1) matrix (``dim`` None: 1 for a Linear,
    whose weight is (in, out), else 0): ``<name>_orig`` the trainable
    parameter, ``<name>_u`` / ``<name>_v`` the buffers. σ = uᵀ W v is
    differentiated through W; the iteration is not."""
    if dim is None:
        dim = 1 if "linear" in type(layer).__name__.lower() else 0
    w = getattr(layer, name).detach()
    rows, cols = _moved(w, dim).shape
    u = torch.randn(rows, generator=generator, device=w.device)
    v = torch.randn(cols, generator=generator, device=w.device)
    u = u / (torch.linalg.vector_norm(u) + eps)
    v = v / (torch.linalg.vector_norm(v) + eps)
    _swap_parameter(layer, name, {f"{name}_orig": w.clone()})
    layer.register_buffer(f"{name}_u", u.to(w.dtype))
    layer.register_buffer(f"{name}_v", v.to(w.dtype))

    def compute(lay, *args):
        wo = getattr(lay, f"{name}_orig")
        ub = getattr(lay, f"{name}_u")
        vb = getattr(lay, f"{name}_v")
        with torch.no_grad():
            wm = _moved(wo, dim)
            uu, vv = ub, vb
            for _ in range(n_power_iterations):
                vv = wm.T @ uu
                vv = vv / (torch.linalg.vector_norm(vv) + eps)
                uu = wm @ vv
                uu = uu / (torch.linalg.vector_norm(uu) + eps)
            ub.copy_(uu)
            vb.copy_(vv)
            shape = [wo.shape[dim]] + [s for i, s in enumerate(wo.shape)
                                       if i != dim]
            uv = torch.outer(uu, vv).reshape(shape).movedim(0, dim)
        setattr(lay, name, wo / (wo * uv).sum())

    handle = layer.register_forward_pre_hook(compute)
    layer._spectral_norm_hook = (handle, name)
    compute(layer)
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters' values, flattened and concatenated (detached)."""
    vals = [p.detach().reshape(-1) for p in parameters]
    return torch.cat(vals) if vals else torch.zeros(0)


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive pieces of ``vec`` into the parameters, in place
    (a CUDA graph reads them by address), each in its own dtype."""
    off = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[off:off + n].reshape(p.shape).to(p.dtype))
        off += n
    return parameters
