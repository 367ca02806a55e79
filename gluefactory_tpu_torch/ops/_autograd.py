"""Gradients through the hand-written kernels: the kernel runs forward, the
backward recomputes the plain PyTorch version and differentiates it.

This is what the JAX package's custom VJPs do around its Pallas kernels
(`_flash_bwd`, `_flash_bidir_bwd`, `_vgg_ad_bwd`: a jnp reference under
`jax.vjp`); Sinkhorn's gradient is that of the plain loop, the route JAX
trains on. A wrapper calls `kernel_with_plain_grad` on a CUDA tensor when
`needs_grad` says autograd is recording an input that requires a gradient,
and its kernel directly otherwise, with nothing saved.
"""

from __future__ import annotations

import torch


def needs_grad(*args) -> bool:
    """Autograd is recording and a tensor among `args` requires a gradient."""
    return torch.is_grad_enabled() and any(torch.is_tensor(a) and a.requires_grad for a in args)


class KernelWithPlainGrad(torch.autograd.Function):
    """forward(kernel, plain, *args) = kernel(*args), saving the tensor
    arguments; backward differentiates plain(*args) on detached copies.
    Arguments that are not tensors (None masks, ints, flags) are passed as
    they are and get no gradient; neither do tensors that do not require
    one (masks)."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.is_tensor = [torch.is_tensor(a) for a in args]
        ctx.constants = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a in args if torch.is_tensor(a)))
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grads):
        wanted = ctx.needs_input_grad[2:]
        saved = iter(ctx.saved_tensors)
        args = []
        for is_t, const, want in zip(ctx.is_tensor, ctx.constants, wanted):
            if is_t:
                a = next(saved).detach()
                args.append(a.requires_grad_(True) if want else a)
            else:
                args.append(const)
        with torch.enable_grad():
            out = ctx.plain(*args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        inputs = [a for a, want in zip(args, wanted) if want]
        got = iter(torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs],
                                       allow_unused=True) if pairs and inputs else [None] * len(inputs))
        return (None, None, *(next(got) if want else None for want in wanted))


def kernel_with_plain_grad(kernel, plain, *args):
    """kernel(*args), differentiable as plain(*args) is."""
    return KernelWithPlainGrad.apply(kernel, plain, *args)
