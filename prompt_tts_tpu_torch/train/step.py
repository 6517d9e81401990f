"""The training step: DDPM noise, ε-MSE, backward, clip+AdamW.

Port of ``prompt_tts_tpu/train/step.py`` (reference train.py:86-120).  The
JAX step is one jitted program; here it runs eagerly on the model's device:
draw per-example noise, timesteps and (with classifier-free guidance
training) the condition drop from an explicit ``torch.Generator``, run the
forward process, predict ε with dropout on, take the MSE in f32, backward
(through the attention-backward kernel on the card), then
:meth:`TrainState.apply_gradients`.

Both families: a batch with a ``prompt`` key (the prompt-conditioned
family's voice-prompt latents) passes it to the model, and the condition
drop nulls the text and the prompt together.  For parity tests the noise,
timesteps and drop can be passed in instead of drawn.

Data parallelism (``shard=(rank, size)``, the trainer under a process
group): the batch holds this rank's rows of a global batch of ``size``
times as many.  The noise, timesteps and drop are drawn for the global
batch from the generator every rank seeds alike, and each rank keeps its
rows, so ``size`` ranks draw what one process draws; given ones are the
global batch's too.  The model passed as ``module`` (the
``DistributedDataParallel`` wrapper) averages the gradients over the
ranks in its backward hooks, and the step's ``loss`` is the mean over
the ranks.  Dropout draws from the device's default generator, which the
trainer sets to a stream of its own for each rank
(:func:`drawing_from`).

``remat=True`` (``--remat``, JAX's ``jax.checkpoint``) runs each block
of the model (every resnet block, spatial transformer, and text or
prompt encoder layer) as its own non-reentrant ``torch.utils.checkpoint``
region: a block keeps only its inputs, and the backward pass recomputes
it, attention kernel included, one block at a time.  JAX wraps the whole
model in one region with ``dots_with_no_batch_dims_saveable``, where XLA
fuses the recomputed elementwise work into the backward.  Eager PyTorch
has no such fusion (``chip_smoke.py --remat-times``, the flagship's bf16
step at batch 32 on an NVIDIA H100 80GB HBM3 at 700 W; plain 0.159 s,
16.31 GiB): that policy as a selective checkpoint (matmul outputs kept)
over one region recomputes the whole forward at once and holds it again
(0.371 s, 16.29 GiB); over a region a block it keeps the linear layers'
outputs and runs a Python dispatch mode over every op (0.426 s, 9.03
GiB); a plain region a block takes 0.271 s and 4.72 GiB.  A
block with active dropout restores the global generators before its
recompute, so it draws the same masks; every op on the path is
deterministic, so the loss and gradients are the bits of the step
without remat.  The ``rbg`` dropout stream is not ported.
"""

import contextlib
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from prompt_tts_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, add_noise,
)
from prompt_tts_tpu_torch.parallel import mean_over_ranks
from prompt_tts_tpu_torch.train.state import TrainState

Shard = Optional[Tuple[int, int]]


def _rows(x: torch.Tensor, local: int, shard: Shard) -> torch.Tensor:
    """This rank's rows of ``x``, a draw for the global batch."""
    rank, size = shard or (0, 1)
    if x.shape[0] != local * size:
        raise ValueError(f"expected {local * size} rows (the global "
                         f"batch), got {x.shape[0]}")
    return x[rank * local:(rank + 1) * local]


def _draw(codes: torch.Tensor, num_train_timesteps: int,
          generator: Optional[torch.Generator], noise, timesteps,
          shard: Shard = None):
    """The noise, then the timesteps, of the global batch (drawn unless
    given), cut to this rank's rows of ``codes``."""
    B = codes.shape[0]
    G = B * (shard[1] if shard else 1)
    if noise is None:
        noise = torch.randn((G,) + tuple(codes.shape[1:]),
                            generator=generator, device=codes.device,
                            dtype=codes.dtype)
    if timesteps is None:
        timesteps = torch.randint(0, num_train_timesteps, (G,),
                                  generator=generator, device=codes.device)
    return _rows(noise, B, shard), _rows(timesteps, B, shard)


@contextlib.contextmanager
def drawing_from(generator: torch.Generator, device: torch.device):
    """Run the block with ``device``'s default generator (the one dropout
    draws from) in ``generator``'s state, then carry the state the block
    leaves back into ``generator`` and give the default its own back."""
    if device.type == "cuda":
        get = functools.partial(torch.cuda.get_rng_state, device)
        put = functools.partial(torch.cuda.set_rng_state, device=device)
    else:
        get, put = torch.get_rng_state, torch.set_rng_state
    saved = get()
    put(generator.get_state())
    try:
        yield
    finally:
        generator.set_state(get())
        put(saved)


def _mse(pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - noise.float()) ** 2)


def _condition(batch: Dict[str, torch.Tensor]):
    """The model's conditioning inputs of a batch: ids and mask, and the
    prompt latents when the batch has them (the prompt family)."""
    cond = (batch["text_ids"], batch["text_mask"])
    if "prompt" in batch:
        cond = cond + (batch["prompt"],)
    return cond


def remat_blocks(model: nn.Module) -> List[nn.Module]:
    """The modules that ``remat`` checkpoints one by one: the resnet
    blocks, the spatial transformers, and the transformer layers outside
    them (the text and prompt encoders')."""
    from prompt_tts_tpu_torch.models.layers import TransformerBlock
    from prompt_tts_tpu_torch.models.unet1d import (
        ResnetBlock1D, SpatialTransformer1D,
    )
    inside = {id(b) for m in model.modules()
              if isinstance(m, SpatialTransformer1D) for b in m.modules()}
    return [m for m in model.modules()
            if isinstance(m, (ResnetBlock1D, SpatialTransformer1D))
            or (isinstance(m, TransformerBlock) and id(m) not in inside)]


def _draws(block: nn.Module) -> bool:
    """Whether ``block`` draws random numbers in training (a dropout with
    p > 0): only then must its recompute restore the generators."""
    return any(isinstance(m, nn.Dropout) and m.p > 0
               for m in block.modules())


@contextlib.contextmanager
def _checkpointed(blocks: List[nn.Module]):
    """Run each of ``blocks`` as its own checkpoint region while the
    context is open."""
    for m in blocks:
        m.forward = functools.partial(checkpoint, m.forward,
                                      use_reentrant=False,
                                      preserve_rng_state=_draws(m))
    try:
        yield
    finally:
        for m in blocks:
            del m.forward       # back to the class's forward


def _model_fn(model: nn.Module, remat: bool) -> Callable:
    """``model`` itself, or under remat the model with its blocks
    checkpointed."""
    if not remat:
        return model
    blocks = remat_blocks(model)

    def remat_model(*args):
        with _checkpointed(blocks):
            return model(*args)
    return remat_model


def make_loss_fn(model: nn.Module, schedule: DiffusionSchedule,
                 cond_dropout_prob: float = 0.0,
                 remat: bool = False, shard: Shard = None) -> Callable:
    """The DDPM ε-MSE over one batch: ``codes [B,T,C]`` in [-1, 1],
    ``text_ids [B,S]``, ``text_mask [B,S]`` and, for the prompt family,
    ``prompt [B,Tp,C]``.  ``cond_dropout_prob`` > 0 nulls the conditioning
    of each sample with that probability (classifier-free guidance
    training): zero ids, an all-zero mask and zero prompt latents, the
    null branch the sampler's guidance pairs against.

    ``loss_fn(batch, generator, noise=None, timesteps=None, drop=None)``
    draws noise, then timesteps, then the drop from ``generator``, unless
    they are given.  ``remat`` recomputes the activations in the backward
    pass; ``shard`` is this rank's place on the data axis (see the module
    docstring).
    """
    model_fn = _model_fn(model, remat)

    def loss_fn(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        codes = batch["codes"]
        B = codes.shape[0]
        noise, timesteps = _draw(codes, schedule.num_train_timesteps,
                                 generator, noise, timesteps, shard)
        noisy = add_noise(schedule, codes, noise, timesteps)
        cond = _condition(batch)
        if cond_dropout_prob > 0.0:
            if drop is None:
                drop = torch.rand((B * (shard[1] if shard else 1), 1),
                                  generator=generator,
                                  device=codes.device) < cond_dropout_prob
            drop = _rows(drop, B, shard)
            # [B, 1] broadcasts over ids and mask [B, S]; the prompt
            # [B, Tp, C] takes it as [B, 1, 1]
            cond = tuple(torch.where(drop.view(-1, *[1] * (c.dim() - 1)),
                                     torch.zeros_like(c), c) for c in cond)
        pred = model_fn(noisy, timesteps, *cond)
        return _mse(pred, noise)

    return loss_fn


def make_train_step(state: TrainState, schedule: DiffusionSchedule,
                    cond_dropout_prob: float = 0.0,
                    remat: bool = False, module: Optional[nn.Module] = None,
                    shard: Shard = None) -> Callable:
    """``train_step(batch, generator, **inputs) -> {"loss", "grad_norm"}``
    (device scalars: reading them is the host sync).  ``inputs`` are the
    loss function's ``noise`` / ``timesteps`` / ``drop``.  ``module`` runs
    the forward in place of ``state.model`` (its DDP wrapper); with
    ``shard`` the loss is the mean over the ranks."""
    loss_fn = make_loss_fn(module or state.model, schedule,
                           cond_dropout_prob, remat, shard)

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   **inputs) -> Dict[str, torch.Tensor]:
        state.model.train()
        loss = loss_fn(batch, generator, **inputs)
        loss.backward()
        grad_norm = state.apply_gradients()
        loss = loss.detach()
        return {"loss": mean_over_ranks(loss) if shard else loss,
                "grad_norm": grad_norm}

    return train_step


def eval_generator(device, seed: int, i: int) -> torch.Generator:
    """The generator of eval batch ``i``'s noise and timesteps: a fixed
    stream for each batch index, so eval losses compare across
    checkpoints and runs."""
    return torch.Generator(device).manual_seed(seed * 1_000_003 + i)


def make_eval_step(model: nn.Module, schedule: DiffusionSchedule,
                   shard: Shard = None):
    """Deterministic eval loss (dropout off): noise and timesteps from the
    caller's ``generator``, so a fixed seed gives comparable losses.  With
    ``shard`` they are drawn for the global batch and the loss is this
    rank's rows' mean."""
    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  timesteps: Optional[torch.Tensor] = None) -> torch.Tensor:
        model.eval()
        codes = batch["codes"]
        noise, timesteps = _draw(codes, schedule.num_train_timesteps,
                                 generator, noise, timesteps, shard)
        noisy = add_noise(schedule, codes, noise, timesteps)
        return _mse(model(noisy, timesteps, *_condition(batch)), noise)
    return eval_step


def make_eval_step_at(model: nn.Module, schedule: DiffusionSchedule):
    """The eval loss with every example noised to the caller's timestep
    ``t``: a grid of ``t`` shows where on the noise schedule a model is
    weak."""
    step = make_eval_step(model, schedule)

    def eval_step(batch: Dict[str, torch.Tensor], generator, t: int,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        codes = batch["codes"]
        ts = torch.full((codes.shape[0],), int(t), dtype=torch.long,
                        device=codes.device)
        return step(batch, generator, noise=noise, timesteps=ts)
    return eval_step
