"""Adam as optax computes it, with an optional bfloat16 first moment.

Counterpart of ``optax.adam(lr, mu_dtype=...)`` (the JAX trainer's
optimizer, ``sr3_tpu/training/trainer.py:106-118``). ``torch.optim.Adam``
keeps ``exp_avg`` in the parameter's dtype, so it cannot hold the first
moment in bfloat16; this optimizer follows optax's ``scale_by_adam`` step by
step on foreach tensor ops:

1. mu = (1 - b1) * g + b1 * mu_stored, in float32; with a bfloat16 mu, b1
   is first rounded to bfloat16 (jax casts the Python float to the array's
   dtype) and the product is kept in float32 (exact: 8 by 8 significant
   bits), as XLA computes it;
2. nu = (1 - b2) * g * g + b2 * nu, float32; each of the two sums is one
   fused multiply-add (``add`` with ``alpha``), as XLA fuses them;
3. the update -lr * mu_hat / (sqrt(nu_hat) + eps) from the float32 mu, with
   mu_hat, nu_hat bias-corrected by the float32 1 - b ** step;
4. only then mu is stored, rounded to ``mu_dtype``.

State per parameter, under torch.optim.Adam's names so that checkpoints
stay interchangeable: ``step`` (a float32 CPU tensor), ``exp_avg`` (in
``mu_dtype``) and ``exp_avg_sq`` (float32). ``load_state_dict`` restores
``exp_avg``'s dtype, which ``torch.optim.Optimizer`` would cast to the
parameter's.
"""

from __future__ import annotations

import torch


class Adam(torch.optim.Optimizer):
    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
                 mu_dtype=torch.float32):
        self.mu_dtype = mu_dtype
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    def _init_state(self, p):
        state = self.state[p]
        if not state:
            state["step"] = torch.tensor(0.0)
            state["exp_avg"] = torch.zeros_like(
                p, dtype=self.mu_dtype, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self._init_state(p) for p in params]
            grads = [p.grad for p in params]
            mus = [s["exp_avg"] for s in states]
            nus = [s["exp_avg_sq"] for s in states]
            torch._foreach_add_([s["step"] for s in states], 1)
            # one count for the group, as optax keeps one for the tree
            count = int(states[0]["step"].item())
            # each sum a + c * g in one rounding (a fused multiply-add, as
            # XLA fuses optax's (1 - b) * g + b * m)
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            if self.mu_dtype == torch.float32:
                mu32 = torch._foreach_mul(mus, b1_mu)
            else:
                mu32 = [m.float() for m in mus]
                torch._foreach_mul_(mu32, b1_mu)
            torch._foreach_add_(mu32, grads, alpha=1 - b1)
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2, alpha=1 - b2)
            del g2
            bc1 = float(torch.tensor(1 - b1 ** count, dtype=torch.float32))
            bc2 = float(torch.tensor(1 - b2 ** count, dtype=torch.float32))
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(mu32, bc1)
            torch._foreach_div_(upd, denom)
            del denom
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
            del upd
            torch._foreach_copy_(mus, mu32)
        return loss

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        for state in self.state.values():
            mu = state.get("exp_avg")
            if mu is not None and mu.dtype != self.mu_dtype:
                state["exp_avg"] = mu.to(self.mu_dtype)
