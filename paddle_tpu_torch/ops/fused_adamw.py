"""Fused Adam/AdamW parameter update — port of
``paddle_tpu/ops/fused_adamw.py`` (``_reference_update`` and the one-pass
kernel ``_make_kernel`` / ``_fused_call``).

:func:`fused_adamw_update` updates one tensor's parameter, moments and
optional fp32 master weight IN PLACE (the JAX function returns new arrays;
updating in place saves a copy of the optimizer state) and returns the
same tensors. The learning rate and the bias corrections reach the update
as one fp32 device tensor ``scalars = [lr, 1/(1 - b1^step), 1/(1 -
b2^step)]`` (:func:`adamw_scalars`), the counterpart of the TPU kernel's
scalar block, built on the device in fp32 with the JAX package's
arithmetic from the device learning rate and step count: no host float
enters a launch, so a CUDA graph replays it as the values change. On CUDA
tensors the update launches ``csrc/fused_adamw.cu`` — one elementwise
pass that reads p, g, m, v (and the master) once and writes p, m, v (and
the master) once. On CPU tensors, or under ``set_kernel_mode(
"reference")``, it runs :func:`_reference_update`, which reads the same
scalars. In the JAX package the kernel is opt-in (``PT_FUSED_ADAMW``)
because XLA's fused elementwise update beat it on a TPU; on the card the
alternative is about ten eager ops per tensor, so the port always uses the
kernel on CUDA tensors. The update is the same either way, and there is
no env knob.
"""
from __future__ import annotations

import torch


def adamw_scalars(lr, step, betas):
    """fp32 ``[lr, 1/(1 - b1**step), 1/(1 - b2**step)]`` on ``betas``'s
    device, as the JAX package builds its kernel's scalar block
    (``fused_adamw_update``: the step in fp32, ``b ** step`` and the
    reciprocal in fp32). ``lr``: a 0-d tensor (or a number); ``step``: a
    0-d integer tensor (or an int), 1 for the first update; ``betas``: fp32
    ``[b1, b2]``. No host read: the result can be captured in a graph."""
    dev = betas.device
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    step = torch.as_tensor(step, device=dev).to(torch.float32)
    bc = 1.0 / (1.0 - torch.pow(betas, step))
    return torch.cat([lr.reshape(1), bc])


def _reference_update(param_f32, grad_f32, m, v, scalars, b1, b2, eps,
                      decay):
    """The Adam(W) math both paths implement (the TPU kernel's):
    decoupled decay on the master before the moment update; ``decay=0`` is
    plain Adam; ``param_f32`` is the master weight (or the upcast param);
    ``scalars`` from :func:`adamw_scalars`. Returns (new_master, m2,
    v2)."""
    lr, inv_bc1, inv_bc2 = scalars.to(param_f32.device).unbind()
    master = param_f32 * (1.0 - lr * decay)
    m2 = b1 * m + (1.0 - b1) * grad_f32
    v2 = b2 * v + (1.0 - b2) * grad_f32 * grad_f32
    mhat = m2 * inv_bc1
    vhat = v2 * inv_bc2
    new_master = master - lr * mhat / (torch.sqrt(vhat) + eps)
    return new_master, m2, v2


def fused_adamw_cuda(param, grad, m, v, master=None, *, scalars, b1, b2,
                     eps, decay):
    """Launch the one-pass AdamW kernel: param (bfloat16, or float32 with
    no master: the parameter is its own fp32 weight), grad (bfloat16 or
    float32), m, v and master (float32), all contiguous, one shape, on one
    CUDA device; updated in place; ``scalars`` the fp32 (3,) device tensor
    of :func:`adamw_scalars` on that device. Raises on anything else."""
    from . import _build

    tensors = [param, grad, m, v] + ([master] if master is not None else [])
    if not all(t.is_cuda for t in tensors + [scalars]) or \
            len({t.device for t in tensors + [scalars]}) != 1:
        raise ValueError("fused_adamw_cuda: all tensors must be on one CUDA "
                         "device")
    if any(t.shape != param.shape for t in tensors):
        raise ValueError("fused_adamw_cuda: param, grad, moments and master "
                         "must have one shape")
    p_fp32 = param.dtype == torch.float32 and master is None
    if (param.dtype != torch.bfloat16 and not p_fp32) or grad.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"fused_adamw_cuda: the kernel takes a bfloat16 "
                        f"param (or a float32 one without a master) and a "
                        f"bfloat16 or float32 grad, got {param.dtype} and "
                        f"{grad.dtype}")
    if any(t.dtype != torch.float32 for t in tensors[2:]):
        raise TypeError("fused_adamw_cuda: moments and master must be "
                        "float32")
    if scalars.dtype != torch.float32 or scalars.shape != (3,) or \
            not scalars.is_contiguous():
        raise TypeError("fused_adamw_cuda: scalars must be a contiguous "
                        "float32 (3,) tensor [lr, 1/bc1, 1/bc2]")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("fused_adamw_cuda: tensors must be contiguous and "
                         "16-byte aligned (updated in place)")
    n = param.numel()     # 64-bit in the kernel: a flat model's state
    if n == 0:
        return
    lib = _build.library()
    err = lib.pt_fused_adamw(
        param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(),
        master.data_ptr() if master is not None else None, n,
        int(grad.dtype == torch.float32), int(p_fp32), scalars.data_ptr(),
        float(b1),
        float(1.0 - b1), float(b2), float(1.0 - b2), float(eps),
        float(decay), _build.stream_ptr(param.device))
    _build.check(err, "fused_adamw")
    fused_adamw_cuda.launches += 1


fused_adamw_cuda.launches = 0


@torch.no_grad()
def fused_adamw_update(param, grad, m, v, *, scalars=None, lr=None,
                       step=None, b1, b2, eps, decay, master=None):
    """One Adam(W) step for one tensor, in place: ``param`` (and ``master``
    when given, the fp32 weight the update is computed on), ``m`` and
    ``v`` (fp32) are overwritten. ``grad`` is consumed in fp32 either way.
    The step's learning rate and bias corrections come as ``scalars``
    (:func:`adamw_scalars`, built once a step for every tensor), or as
    ``lr`` and ``step`` (numbers or 0-d tensors), from which they are
    built here. Returns ``(param, m, v, master)``."""
    from . import use_kernel

    if scalars is None:
        betas = torch.tensor([b1, b2], dtype=torch.float32,
                             device=param.device)
        scalars = adamw_scalars(lr, step, betas)
    if use_kernel(param):
        fused_adamw_cuda(param, grad, m, v, master, scalars=scalars, b1=b1,
                         b2=b2, eps=eps, decay=decay)
        return param, m, v, master
    pf = master if master is not None else param.float()
    new_master, m2, v2 = _reference_update(pf, grad.float(), m, v, scalars,
                                           b1, b2, eps, decay)
    param.copy_(new_master)
    m.copy_(m2)
    v.copy_(v2)
    if master is not None:
        master.copy_(new_master)
    return param, m, v, master
