"""Train state, AdamW and the stage trainability masks.

The counterpart of ``humanvid_tpu/train/state.py`` over the port's module
parameters, named by component and diffusers state-dict key:

- stage 1 trains the denoising UNet (ReferenceNet topology, no motion), the
  ReferenceNet except ``up_blocks.3`` and its ``conv_norm_out``/``conv_out``
  (whose activations never reach the reference features), the PoseGuider
  and the CameraPoseEncoder;
- stage 2 trains the motion modules of the video UNet and the
  CameraPoseEncoder only.

The trainable leaves keep fp32 masters here; the modules compute with
casts of them in the modules' dtype (bf16 on the card), and frozen leaves
are never copied. ``requires_grad`` is set on the trainable leaves only, so
autograd records no backward through frozen weights. The update is the
JAX package's optax chain: clip by global norm, then AdamW with the
``warmup_constant`` learning rate, which is 0 at step 0 when there is a
warmup, so the first update moves nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

TRAIN_COMPONENTS = ("reference_unet", "denoising_unet", "pose_guider", "camera_encoder")

Predicate = Callable[[str, str], bool]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 1e-2
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_steps: int = 0


def stage1_trainable(component: str, name: str) -> bool:
    if component in ("denoising_unet", "pose_guider", "camera_encoder"):
        return True
    if component == "reference_unet":
        return not name.startswith(("up_blocks.3.", "conv_norm_out.", "conv_out."))
    return False


def stage2_trainable(component: str, name: str) -> bool:
    if component == "camera_encoder":
        return True
    if component == "denoising_unet":
        return ".motion_modules." in name
    return False


def learning_rate(config: OptimizerConfig, step: int) -> float:
    """optax's ``warmup_constant_schedule(0, lr, warmup_steps)`` at ``step``
    (the number of updates taken before this one)."""
    if config.warmup_steps > 0 and step < config.warmup_steps:
        return config.learning_rate * step / config.warmup_steps
    return config.learning_rate


class TrainState:
    """The step count, the trainable leaves with their fp32 masters, and
    AdamW's two moments, in one flat order named ``component/key``."""

    def __init__(self, system, predicate: Predicate,
                 config: OptimizerConfig = OptimizerConfig()):
        self.config = config
        self.step = 0
        self.names: List[str] = []
        self.params: List[torch.nn.Parameter] = []
        for component in TRAIN_COMPONENTS:
            for name, p in getattr(system, component).named_parameters():
                train = predicate(component, name)
                p.requires_grad_(train)
                if train:
                    self.names.append(f"{component}/{name}")
                    self.params.append(p)
        if not self.params:
            raise ValueError("the predicate selects no trainable parameter")
        self.masters = [p.detach().float().clone() for p in self.params]
        self.mu = [torch.zeros_like(m) for m in self.masters]
        self.nu = [torch.zeros_like(m) for m in self.masters]

    def grads(self) -> List[torch.Tensor]:
        """fp32 copies of the trainable leaves' gradients (zero where none
        arrived)."""
        return [torch.zeros_like(m) if p.grad is None else p.grad.to(torch.float32, copy=True)
                for p, m in zip(self.params, self.masters)]

    @torch.no_grad()
    def apply_gradients(self) -> torch.Tensor:
        """One update from the leaves' ``.grad``: clip by global norm, AdamW
        on the masters, copy the masters back into the modules, clear the
        gradients. Returns the global norm before clipping."""
        c = self.config
        grads = self.grads()
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads]))
        # optax clip_by_global_norm: g unchanged below the limit, else g / norm * limit
        factor = torch.where(norm < c.max_grad_norm, torch.ones_like(norm),
                             c.max_grad_norm / norm)
        torch._foreach_mul_(grads, factor)
        torch._foreach_mul_(self.mu, c.beta1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - c.beta1)
        torch._foreach_mul_(self.nu, c.beta2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - c.beta2)
        del grads
        count = self.step + 1
        denom = torch._foreach_div(self.nu, 1.0 - c.beta2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, c.eps)
        update = torch._foreach_div(self.mu, 1.0 - c.beta1 ** count)
        torch._foreach_div_(update, denom)
        del denom
        torch._foreach_add_(update, self.masters, alpha=c.weight_decay)
        torch._foreach_add_(self.masters, update, alpha=-learning_rate(c, self.step))
        for p, m in zip(self.params, self.masters):
            p.copy_(m)
            p.grad = None
        self.step = count
        return norm

    def state_dict(self) -> Dict[str, object]:
        """Step and moments by leaf name (the masters travel with the
        modules' checkpoints)."""
        return {"step": self.step,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object],
                        masters: Dict[str, torch.Tensor]) -> None:
        """Restore the step and moments, and the masters from ``masters``
        (fp32, by leaf name), which are copied into the modules."""
        self.step = int(state["step"])
        for i, name in enumerate(self.names):
            self.mu[i].copy_(state["mu"][name])
            self.nu[i].copy_(state["nu"][name])
            self.masters[i].copy_(masters[name])
            self.params[i].copy_(self.masters[i])
