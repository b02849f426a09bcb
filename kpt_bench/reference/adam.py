"""The plain reference of the optimizer: clip by global norm, then Adam with a
cosine-decayed step size, as optax's chain(clip_by_global_norm(clip),
adam(cosine_decay_schedule(lr, decay_steps, alpha))) computes it.

Written from optax's definitions, not from the program: β1 = 0.9,
β2 = 0.999, ε = 1e-8 outside the square root, bias corrections in the
parameters' dtype, the schedule's count starting at 0.
"""

from __future__ import annotations

import math

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class Adam:
    def __init__(self, params: dict, lr: float, decay_steps: int, alpha: float, clip: float | None):
        self.lr, self.decay_steps, self.alpha, self.clip = lr, decay_steps, alpha, clip
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.first_grad = None  # the (clipped) gradient of the first update

    def resume(self, m: dict, v: dict, count: int) -> None:
        """Continue from a state: the moments by key and the steps taken."""
        self.m = {k: m[k].to(p.dtype).clone() for k, p in self.params.items()}
        self.v = {k: v[k].to(p.dtype).clone() for k, p in self.params.items()}
        self.count = int(count)

    def _lr(self) -> float:
        c = min(self.count, self.decay_steps)
        f = (1.0 - self.alpha) * 0.5 * (1.0 + math.cos(math.pi * c / self.decay_steps)) + self.alpha
        return self.lr * f

    @torch.no_grad()
    def update(self, grads: dict) -> dict:
        g = {k: grads[k].to(self.params[k].dtype) for k in self.params}
        if self.clip is not None:
            norm = torch.sqrt(sum(torch.sum(g[k] * g[k]) for k in sorted(g)))
            if norm >= self.clip:
                g = {k: v / norm * self.clip for k, v in g.items()}
        if self.first_grad is None:
            self.first_grad = {k: v.clone() for k, v in g.items()}
        t = self.count + 1
        lr = self._lr()
        for k, p in self.params.items():
            self.m[k] = BETA1 * self.m[k] + (1.0 - BETA1) * g[k]
            self.v[k] = BETA2 * self.v[k] + (1.0 - BETA2) * g[k] * g[k]
            bc1 = 1.0 - torch.tensor(BETA1, dtype=p.dtype) ** t
            bc2 = 1.0 - torch.tensor(BETA2, dtype=p.dtype) ** t
            m_hat = self.m[k] / bc1.to(p.device)
            v_hat = self.v[k] / bc2.to(p.device)
            p -= lr * m_hat / (torch.sqrt(v_hat) + EPS)
        self.count = t
        return self.params
