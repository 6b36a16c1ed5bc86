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
``warmup_constant`` learning rate, which is 0 at update 0 when there is a
warmup, so the first update moves nothing. With
``gradient_accumulation_steps`` k > 1 it is optax ``MultiSteps``: each
micro-step folds its gradients into their running mean, and the k-th
applies the chain to that mean; the learning rate and AdamW's bias
corrections count updates, not micro-steps. With ``mu_dtype="bfloat16"``
the first moment is stored in bf16, as optax's ``scale_by_adam`` stores
it: the new moment and the update from it are computed in fp32 and only
the stored moment is rounded; the moment's decay is beta1 rounded to bf16
(0.8984375 for 0.9), as in the jitted JAX step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

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
    # only "constant" (with the warmup above), as in the JAX package
    lr_schedule: str = "constant"
    # micro-steps a update: optax ``MultiSteps`` over the clip-then-AdamW chain
    gradient_accumulation_steps: int = 1
    # storage dtype of AdamW's first moment (None: fp32; "bfloat16" halves it)
    mu_dtype: Optional[str] = None


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


MU_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState:
    """The micro-step count, the trainable leaves with their fp32 masters,
    AdamW's two moments and, under accumulation, the running mean of the
    micro-steps' gradients, in one flat order named ``component/key``.

    ``step`` counts micro-steps (the JAX state's ``step``, which the
    drivers resume), ``updates`` the updates taken, and ``micro`` the
    micro-steps folded into ``acc`` since the last update."""

    def __init__(self, system, predicate: Predicate,
                 config: OptimizerConfig = OptimizerConfig()):
        if config.lr_schedule != "constant":
            raise ValueError(config.lr_schedule)
        if config.gradient_accumulation_steps < 1:
            raise ValueError(f"gradient_accumulation_steps {config.gradient_accumulation_steps}")
        if config.mu_dtype not in MU_DTYPES:
            raise ValueError(f"mu_dtype {config.mu_dtype!r}")
        self.config = config
        self.step = 0
        self.updates = 0
        self.micro = 0
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
        self.mu = [torch.zeros_like(m, dtype=MU_DTYPES[config.mu_dtype]) for m in self.masters]
        self.nu = [torch.zeros_like(m) for m in self.masters]
        self.acc = ([torch.zeros_like(m) for m in self.masters]
                    if config.gradient_accumulation_steps > 1 else [])

    def grads(self) -> List[torch.Tensor]:
        """fp32 copies of the trainable leaves' gradients (zero where none
        arrived)."""
        return [torch.zeros_like(m) if p.grad is None else p.grad.to(torch.float32, copy=True)
                for p, m in zip(self.params, self.masters)]

    @torch.no_grad()
    def apply_gradients(self) -> torch.Tensor:
        """One micro-step from the leaves' ``.grad``, which it clears; on
        the k-th micro-step (every one when k = 1) an update: clip by global
        norm, AdamW on the masters, the masters copied back into the
        modules. Returns the micro-step's global norm before clipping, as a
        device tensor."""
        c = self.config
        k = c.gradient_accumulation_steps
        grads = self.grads()
        for p in self.params:
            p.grad = None
        norm = _global_norm(grads)
        self.step += 1
        if k > 1:
            # optax MultiSteps' running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, self.micro + 1)
            torch._foreach_add_(self.acc, delta)
            del delta, grads
            self.micro += 1
            if self.micro < k:
                return norm
            self.micro = 0
            self._update(self.acc, _global_norm(self.acc))
            torch._foreach_zero_(self.acc)
        else:
            self._update(grads, norm)
        return norm

    def _update(self, grads: List[torch.Tensor], norm: torch.Tensor) -> None:
        """Clip ``grads`` (scaled in place) by ``norm``, then AdamW."""
        c = self.config
        # optax clip_by_global_norm: g unchanged below the limit, else g / norm * limit
        factor = torch.where(norm < c.max_grad_norm, torch.ones_like(norm),
                             c.max_grad_norm / norm)
        torch._foreach_mul_(grads, factor)
        # optax's (1 - b1) g + b1 mu as the JAX package runs it (jitted): b1,
        # a weak-typed scalar, takes mu's dtype (0.8984375 in bf16), and XLA
        # computes the rest in fp32; fp32 moments are the stored tensors
        mu = [m.float() for m in self.mu]
        torch._foreach_mul_(mu, float(torch.tensor(c.beta1, dtype=self.mu[0].dtype)))
        torch._foreach_add_(mu, grads, alpha=1.0 - c.beta1)
        torch._foreach_mul_(self.nu, c.beta2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - c.beta2)
        del grads
        count = self.updates + 1
        denom = torch._foreach_div(self.nu, 1.0 - c.beta2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, c.eps)
        update = torch._foreach_div(mu, 1.0 - c.beta1 ** count)
        torch._foreach_div_(update, denom)
        del denom
        if mu[0] is not self.mu[0]:  # stored in bf16: rounded only here
            torch._foreach_copy_(self.mu, mu)
        del mu
        torch._foreach_add_(update, self.masters, alpha=c.weight_decay)
        torch._foreach_add_(self.masters, update, alpha=-learning_rate(c, self.updates))
        for p, m in zip(self.params, self.masters):
            p.copy_(m)
        self.updates = count

    def state_dict(self) -> Dict[str, object]:
        """Counts, moments and the accumulation by leaf name (the masters
        travel with the modules' checkpoints)."""
        return {"step": self.step, "updates": self.updates, "micro": self.micro,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu)),
                "acc": dict(zip(self.names, self.acc))}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore what :meth:`state_dict` returned."""
        for key in ("step", "updates", "micro"):
            setattr(self, key, int(state[key]))
        for own, key in ((self.mu, "mu"), (self.nu, "nu"), (self.acc, "acc")):
            for i, t in enumerate(own):
                t.copy_(state[key][self.names[i]])

    @torch.no_grad()
    def load_masters(self, masters: Dict[str, torch.Tensor]) -> None:
        """Set the masters found in ``masters`` (by leaf name, fp32) and copy
        them into the modules."""
        for i, name in enumerate(self.names):
            if name in masters:
                self.masters[i].copy_(masters[name])
                self.params[i].copy_(self.masters[i])


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))
