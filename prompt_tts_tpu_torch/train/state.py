"""Train state: the model, its optimizer chain, gradient accumulation, EMA.

Port of ``prompt_tts_tpu/train/state.py`` (reference train.py:41-47,
116-117): global-norm clip 1.0, then AdamW (betas 0.95/0.999, eps 1e-8,
weight decay 1e-6) at the schedule's
learning rate for the update count.  Gradient accumulation follows
``optax.MultiSteps``: a running (Welford) mean of the micro-step gradients,
one clip+AdamW update every ``gradient_accumulation_steps`` micro-steps,
and a schedule that counts updates only.  The EMA of the parameters moves
at the update boundary only.

Under data parallelism the gradients reach :meth:`TrainState.apply_gradients`
already averaged over the ranks (DDP all-reduces every micro-step's), so
the clip, ``grad_norm`` and the accumulated mean are the global ones.
Under tensor parallelism (``parallel/tp.py``) a rank holds slices of some
parameters: the global norm sums the squares of the sliced gradients over
the model group and counts each whole (replicated) one once; AdamW, the
accumulation and the EMA run unchanged on the slices.

The optimizer is a stock ``torch.optim.AdamW`` (fused on the card), the
same update as optax's ``adamw``: ``p -= lr * (m_hat / (sqrt(v_hat) + eps)
+ wd * p)``.  The frozen Fourier time projection (``unet.time_proj.
weight``) is a buffer, so it is outside the optimizer, its weight decay,
the clip's norm and the EMA, which JAX gets from ``decay_mask`` and
``stop_gradient`` (``state.py:31-47``).  Parameters, gradients, moments and the EMA are f32; a bf16
model casts its weights per call (``models.layers.set_compute_dtype_``).
"""

from typing import Dict, List, Optional

import torch
from torch import nn

from prompt_tts_tpu_torch.config import TrainConfig
from prompt_tts_tpu_torch.parallel import model_group
from prompt_tts_tpu_torch.parallel.tp import sharded_mask
from prompt_tts_tpu_torch.train.lr import get_schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in f32 (optax
    ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def sharded_global_norm(tensors: List[torch.Tensor], sharded: List[bool],
                        group) -> torch.Tensor:
    """:func:`global_norm` of a model whose ``sharded`` tensors are this
    rank's slices: their squares summed over ``group``, the others'
    counted once."""
    sq = torch.stack(torch._foreach_norm([t.float() for t in tensors])) ** 2
    mask = torch.tensor(sharded, device=sq.device)
    part = torch.where(mask, sq, torch.zeros_like(sq)).sum()
    torch.distributed.all_reduce(part, group=group)
    return torch.sqrt(part + torch.where(mask, torch.zeros_like(sq),
                                         sq).sum())


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Scale ``grads`` in place as optax's ``clip_by_global_norm`` does:
    ``g if norm < max_norm else g / norm * max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``), without a host sync.  Returns the
    norm."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    params = [p for p in model.parameters() if p.requires_grad]
    on_card = all(p.device.type == "cuda" for p in params)
    return torch.optim.AdamW(
        [{"params": params, "weight_decay": cfg.weight_decay}],
        lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2),
        eps=cfg.adam_eps, fused=on_card or None,
        foreach=None if on_card else True)


class TrainState:
    """``model`` with its optimizer, accumulation buffers and EMA.

    ``update_count`` is the number of optimizer updates applied (the
    schedule's step, optax's ``count``); ``mini_step`` the micro-steps
    accumulated since the last update (``MultiSteps.mini_step``).
    """

    def __init__(self, model: nn.Module, cfg: TrainConfig,
                 num_training_steps: int):
        self.model = model
        self.cfg = cfg
        self.names = [n for n, p in model.named_parameters()
                      if p.requires_grad]
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.sharded = sharded_mask(self.params)
        self.optimizer = make_optimizer(model, cfg)
        self.schedule = get_schedule(
            cfg.lr_scheduler, learning_rate=cfg.learning_rate,
            num_warmup_steps=cfg.lr_warmup_steps,
            num_training_steps=num_training_steps)
        self.update_count = 0
        self.mini_step = 0
        self.acc_grads: Optional[List[torch.Tensor]] = None
        self.ema: Optional[List[torch.Tensor]] = None
        if cfg.ema_decay > 0.0:
            self.ema = [p.detach().clone() for p in self.params]

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole model's ``grads`` (this rank's
        slices under tensor parallelism)."""
        if any(self.sharded):
            return sharded_global_norm(grads, self.sharded, model_group())
        return global_norm(grads)

    def _micro_grads(self) -> List[torch.Tensor]:
        # a parameter the loss did not reach gets a zero gradient, as in
        # JAX, so its moments and weight decay still move
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def apply_gradients(self) -> torch.Tensor:
        """Consume one micro-step's ``.grad``s; run clip+AdamW (+EMA) when
        the accumulation boundary is reached.  Returns the global norm of
        this micro-step's gradients (the train step's ``grad_norm``)."""
        grads = self._micro_grads()
        norm = self.global_norm(grads)
        k = self.cfg.gradient_accumulation_steps
        if k > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(g) for g in grads]
            # Welford mean, as optax.MultiSteps: acc += (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc_grads)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc_grads, delta)
            self.mini_step += 1
            if self.mini_step < k:
                self.optimizer.zero_grad(set_to_none=True)
                return norm
            self.mini_step = 0
            for p, a in zip(self.params, self.acc_grads):
                p.grad = a
            self.acc_grads = None
            grads = self._micro_grads()
            clip_by_global_norm_(grads, self.cfg.max_grad_norm,
                                 self.global_norm(grads))
        else:
            clip_by_global_norm_(grads, self.cfg.max_grad_norm, norm)
        lr = float(self.schedule(self.update_count))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.update_count += 1
        if self.ema is not None:
            d = self.cfg.ema_decay
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, [p.detach() for p in self.params],
                                alpha=1.0 - d)
        return norm

    def state_dict(self) -> Dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "ema": None if self.ema is None else dict(zip(self.names,
                                                          self.ema)),
            "acc_grads": None if self.acc_grads is None else dict(
                zip(self.names, self.acc_grads)),
            "update_count": self.update_count,
            "mini_step": self.mini_step,
        }

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.ema is not None:
            # a checkpoint without an EMA re-seeds it from the parameters
            src = sd.get("ema") or dict(zip(self.names, self.params))
            self.ema = [src[n].detach().to(p.device, torch.float32).clone()
                        for n, p in zip(self.names, self.params)]
        acc = sd.get("acc_grads")
        self.acc_grads = None if acc is None else [
            acc[n].to(p.device) for n, p in zip(self.names, self.params)]
        self.update_count = int(sd["update_count"])
        self.mini_step = int(sd["mini_step"])
