"""The training loop: epochs, the train step, metrics, checkpoints.

Port of ``prompt_tts_tpu/train/loop.py`` (reference train.py:21-147) for
both model families (``TTSPromptSpeaker`` when the config has
``prompt_conditioning``, else ``TTSSingleSpeaker``).  Steps are enqueued
eagerly; the loss and gradient norm are pulled to the host (a device sync)
every ``log_every`` steps.  ``remat`` recomputes activations in the
backward pass (``train/step.py``); ``profile_steps`` N > 0 traces steps
2 .. 2+N with ``torch.profiler`` (host and device) into a Chrome trace
under ``<log_dir>/trace/``, each step inside ``record_function
("train_step")``.  The dataset may be the in-RAM ``CodeDataset`` or the
``StreamingCodeDataset``.

Data parallelism: under a ``torch.distributed`` process group
(``parallel.init_distributed``, the CLI's ``--multihost``) each process
is one rank with one device, the model runs inside
``DistributedDataParallel``, and a step of ``P`` ranks over a global
batch computes what one process computes over the same rows.  Each rank
collates the whole global batch and keeps its rows
(``parallel.shard_batch``), or with ``per_process_data`` collates only
its rows (the datasets' ``process_shard``; the prompt family's crops are
then seeded by rank, as in the JAX package).  DDP all-reduces the
gradients of every micro-step, so gradient accumulation folds global
gradients into its mean and each micro-step's ``grad_norm`` is the global
one.  Dropout draws from a generator of each rank's own, seeded from
``(seed, rank)``; the noise, timesteps and condition drop from one that
every rank seeds alike (``train/step.py``).  Only rank 0 writes metrics,
traces and checkpoints; every rank restores the same checkpoint.

Tensor parallelism: with a model axis of ``n_model`` ranks
(``parallel.init_distributed(n_model=...)``, the CLI's ``--tp``), the
world is ``data x model`` ranks (``parallel/mesh.py``).  Each rank holds
its slices of the model by ``parallel/tp.py``'s rules; DDP all-reduces
the gradients over the data group only, and the loss, the data rows, the
rank of the dropout stream and the checkpoint's dropout streams are the
data axis's: the ranks of one model group take the same rows and draw the
same dropout masks, or their replicated activations would drift apart.
A checkpoint holds the whole model (``train/checkpoint.py``), so it
restores on any number of model ranks.

Sequence parallelism: with a seq axis of ``n_seq`` ranks
(``parallel.init_distributed(n_seq=...)``, the CLI's ``--sp``) the world
is ``data x model x seq`` ranks and the UNet runs latent time sharded
over each seq group (``parallel/sp.py``).  The ranks of a seq group take
the same rows, the same noise and timesteps (drawn whole) and the same
dropout stream (the data rank's), so they draw one whole mask and keep
their slices.  Each rank backs the whole loss out through the sharded
UNet, which makes its gradient ``n_seq`` times its part, and DDP averages
over data x seq (``parallel.grad_group``): the data average of the whole
gradients, as one process computes them.  The parameters are replicated
over the seq axis, so the checkpoint is the one-rank layout.
"""

import logging
import math
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel as DDP
from torch.profiler import record_function

from prompt_tts_tpu_torch.config import Config
from prompt_tts_tpu_torch.data.dataset import prefetch
from prompt_tts_tpu_torch.diffusion.schedule import linear_schedule
from prompt_tts_tpu_torch.models.layers import set_compute_dtype_
from prompt_tts_tpu_torch.models.prompt_tts import TTSPromptSpeaker
from prompt_tts_tpu_torch.models.tts import TTSSingleSpeaker
from prompt_tts_tpu_torch.parallel import (
    data_rank, data_size, distributed, gather_objects, grad_group,
    mean_over_ranks, model_group, model_rank, model_size, seq_size,
    set_mesh, shard_batch, shard_local_batch, world_rank,
)
from prompt_tts_tpu_torch.parallel.sp import mesh_seq, shard_seq_
from prompt_tts_tpu_torch.parallel.tp import shard_model_
from prompt_tts_tpu_torch.pipeline import random_init_
from prompt_tts_tpu_torch.train.checkpoint import CheckpointManager
from prompt_tts_tpu_torch.train.state import TrainState
from prompt_tts_tpu_torch.train.step import (
    drawing_from, eval_generator, make_eval_step, make_train_step,
)
from prompt_tts_tpu_torch.utils.debug import finite_or_warn
from prompt_tts_tpu_torch.utils.metrics import MetricsWriter, NullMetricsWriter

log = logging.getLogger(__name__)

# what the step takes of a batch; "prompt" only where the dataset makes it
_BATCH_KEYS = ("codes", "text_ids", "text_mask", "prompt")


def dropout_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout stream: a hash of ``(seed,
    rank)``, so ranks draw different masks for their different rows, and
    no rank's stream is the noise stream's (seeded by ``seed``)."""
    words = np.random.SeedSequence([seed, rank]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


def adopt_init_state(model: torch.nn.Module,
                     init_state: Mapping[str, torch.Tensor]) -> None:
    """Load warm-start weights (a port state dict, e.g. a converted
    reference checkpoint) into ``model``, in its dtypes, after checking
    that they are the same tensors at the same shapes (the port of
    ``prompt_tts_tpu/train/loop.py:_adopt_init_params``).  Raises
    ``ValueError`` naming the first missing, extra and mis-shaped names."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in init_state.items()}
    if want != got:
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        shapes = sorted(k for k in want
                        if k in got and want[k] != got[k])[:5]
        raise ValueError(
            "init_state does not match this model config: "
            f"missing={missing} extra={extra} shape-mismatch={shapes} "
            "(is the config the checkpoint was trained under?)")
    model.load_state_dict(init_state, strict=True)


class Trainer:
    """Owns the model, train state and generators and runs epochs over a
    dataset.

    The weights are drawn from ``config.train.seed`` on a CPU generator,
    so every device starts from the same weights, unless ``init_state``
    (a port state dict of the config's model) gives them: a warm start,
    checked by :func:`adopt_init_state`.  A prompt-conditioned config
    needs a dataset that makes prompt crops (``prompt_frames``).
    ``dtype`` bf16 computes in bf16 over f32 parameters and moments (the
    JAX ``--bf16``).  ``log_every`` 0 means 50 on the card
    and 1 on the CPU.  ``eval_every`` > 0 runs :meth:`evaluate` on the
    train set every that many epochs.  The next batch is collated in a
    background thread (:func:`prefetch`) while the step runs.  ``remat``,
    ``profile_steps`` and ``per_process_data``: see the module docstring.
    Under a process group ``config.train.batch_size`` is the global batch
    and must split evenly over the data axis, and ``device`` is this
    rank's.  ``n_model`` and ``n_seq``: the model and seq axes' sizes
    (None: the current mesh's; another value lays the mesh out again, on
    every rank).
    """

    def __init__(self, config: Config, dataset, log_dir: str,
                 ckpt_dir: Optional[str] = None, device="cuda",
                 dtype: torch.dtype = torch.float32, eval_every: int = 0,
                 log_every: int = 0,
                 init_state: Optional[Mapping[str, torch.Tensor]] = None,
                 remat: bool = False, profile_steps: int = 0,
                 per_process_data: bool = False,
                 n_model: Optional[int] = None,
                 n_seq: Optional[int] = None):
        if log_every < 0:
            raise ValueError(f"log_every must be >= 0, got {log_every}")
        if profile_steps < 0:
            raise ValueError(f"profile_steps must be >= 0, got "
                             f"{profile_steps}")
        if (config.model.prompt_conditioning
                and not getattr(dataset, "prompt_frames", None)):
            raise ValueError("Trainer: a prompt-conditioned config needs a "
                             "dataset with prompt_frames (prompt crops)")
        tcfg = config.train
        n_model = model_size() if n_model is None else n_model
        n_seq = seq_size() if n_seq is None else n_seq
        if (n_model, n_seq) != (model_size(), seq_size()):
            set_mesh(n_model, n_seq)
        self.rank, self.world = data_rank(), data_size()
        # the one process that writes metrics, traces and checkpoints
        self.writer = world_rank() == 0
        if tcfg.batch_size % self.world:
            raise ValueError(f"batch_size {tcfg.batch_size} not divisible "
                             f"by process count {self.world}")
        self._pshard = ((self.rank, self.world)
                        if per_process_data and self.world > 1 else None)
        shard = (self.rank, self.world) if distributed() else None
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = config
        self.dataset = dataset
        self.eval_every = eval_every
        self.log_dir = log_dir
        self.profile_steps = profile_steps if self.writer else 0
        self._profiler = None
        self.log_every = log_every or (
            50 if self.device.type == "cuda" else 1)
        model_cls = (TTSPromptSpeaker if config.model.prompt_conditioning
                     else TTSSingleSpeaker)
        self.model = model_cls(config.model, device=self.device)
        if init_state is not None:
            adopt_init_state(self.model, init_state)
        else:
            random_init_(self.model,
                         torch.Generator().manual_seed(tcfg.seed))
        shard_model_(self.model, model_rank(), model_size(), model_group())
        shard_seq_(self.model, mesh_seq())
        set_compute_dtype_(self.model,
                           None if dtype == torch.float32 else dtype)
        self.schedule = linear_schedule(tcfg.num_train_timesteps,
                                        device=self.device)
        self.metrics = (MetricsWriter(log_dir) if self.writer
                        else NullMetricsWriter(log_dir))
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.steps_per_epoch = max(
            1, math.ceil(len(dataset) / tcfg.batch_size))
        self.num_training_steps = (tcfg.num_train_epochs
                                   * self.steps_per_epoch)
        self.state = TrainState(self.model, tcfg, self.num_training_steps)
        # noise, timesteps and condition drops, alike on every rank; and
        # this rank's dropout stream
        self.generator = torch.Generator(self.device).manual_seed(tcfg.seed)
        self.dropout_generator = torch.Generator(self.device).manual_seed(
            dropout_seed(tcfg.seed, self.rank))
        # every parameter is reached by both families' losses, the
        # condition drop included, so DDP needs no unused-parameter search;
        # it averages over the data and seq axes (see the module docstring)
        self.module = self.model if shard is None else DDP(
            self.model, device_ids=([self.device.index]
                                    if self.device.type == "cuda" else None),
            process_group=grad_group())
        self._step_fn = make_train_step(
            self.state, self.schedule,
            cond_dropout_prob=tcfg.cond_dropout_prob, remat=remat,
            module=self.module, shard=shard)
        self._eval_fn = make_eval_step(self.model, self.schedule, shard)
        self.global_step = 0
        self._tput_mark = None

    def _batches(self, dataset, batch_size: int, **kw):
        """``dataset``'s batches: only this rank's rows under
        ``per_process_data``."""
        if self._pshard is not None:
            kw["process_shard"] = self._pshard
        return dataset.batches(batch_size, **kw)

    def _to_device(self, batch: Dict[str, np.ndarray]):
        """This rank's rows of a batch as the dataset yields it, on the
        device."""
        batch = (shard_batch(batch) if self._pshard is None
                 else shard_local_batch(batch))
        return {k: torch.from_numpy(np.asarray(batch[k])).to(self.device)
                for k in _BATCH_KEYS if k in batch}

    def train_step(self, batch: Dict[str, np.ndarray], **inputs):
        """One step on a batch as the dataset yields it (the global batch,
        or this rank's rows under ``per_process_data``); ``inputs`` are
        the loss function's ``noise`` / ``timesteps`` / ``drop`` for the
        global batch.  Returns the step's device scalars."""
        with drawing_from(self.dropout_generator, self.device):
            return self._step_fn(self._to_device(batch), self.generator,
                                 **inputs)

    def save(self) -> None:
        """Checkpoint the state and the generators, every rank's dropout
        stream among them (rank 0 writes; every rank must call it)."""
        dropout = gather_objects(self.dropout_generator.get_state())
        self.ckpt.save(self.state, self.global_step, generators={
            "train": self.generator.get_state(),
            "dropout": torch.stack(dropout)})

    def restore_latest(self) -> Optional[int]:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return None
        step, gens = self.ckpt.restore(self.state)
        self.generator.set_state(gens["train"].cpu())
        dropout = gens["dropout"].cpu()
        if dropout.dim() == 1:          # one process's, before the stack
            dropout = dropout[None]
        if len(dropout) == self.world:
            self.dropout_generator.set_state(dropout[self.rank].clone())
        else:
            log.warning("checkpoint holds %d dropout streams for %d ranks: "
                        "each rank's starts afresh", len(dropout),
                        self.world)
        self.global_step = step
        log.info("restored checkpoint at step %d", step)
        return step

    def train(self, epochs: Optional[int] = None) -> float:
        """Run the epoch loop; Ctrl-C checkpoints before exiting."""
        try:
            return self._train(epochs)
        except KeyboardInterrupt:
            if self.ckpt is not None:
                log.warning("interrupted: saving checkpoint at step %d",
                            self.global_step)
                self.save()
            raise
        finally:
            self._stop_trace()

    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def _stop_trace(self) -> None:
        """Stop the trace, if one runs, and write it as a Chrome trace
        under ``<log_dir>/trace/``."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        trace_dir = os.path.join(self.log_dir, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"steps_{self.global_step}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)

    def _train(self, epochs: Optional[int] = None) -> float:
        tcfg = self.config.train
        epochs = tcfg.num_train_epochs if epochs is None else epochs
        last_loss = float("nan")
        # resume continues the epoch sequence (data order seeds follow the
        # epoch index), rather than replaying epoch 0
        start_epoch = self.global_step // self.steps_per_epoch
        if start_epoch >= epochs:
            log.info("nothing to do: already at epoch %d of %d "
                     "(use --epochs to extend)", start_epoch, epochs)
            return last_loss
        self._tput_mark = None
        for epoch in range(start_epoch, epochs):
            log.info("Starting epoch %d", epoch)
            t_epoch = time.time()
            pending = None
            batches = prefetch(self._batches(
                self.dataset, tcfg.batch_size, shuffle=True,
                seed=tcfg.seed + epoch))
            try:
                for batch in batches:
                    # the same window as the JAX trainer: past the first
                    # two steps (allocator and cuBLAS warm-up)
                    if self.profile_steps and self.global_step == 2:
                        self._start_trace()
                    with record_function("train_step"):
                        m = self.train_step(batch)
                    self.global_step += 1
                    if (self.profile_steps and self.global_step
                            == 2 + self.profile_steps):
                        self._stop_trace()
                    pending = m
                    if self.global_step % self.log_every == 0:
                        last_loss = self._pull_metrics(m)
                        pending = None
            finally:
                # a step that raised abandons the generator: close it, so
                # its worker (and a streaming dataset's) exits
                batches.close()
            if pending is not None:  # epoch tail between cadence points
                last_loss = self._pull_metrics(pending)
            self.metrics.add_scalar("epoch_time_s", time.time() - t_epoch,
                                    self.global_step)
            if self.eval_every and (epoch + 1) % self.eval_every == 0:
                eval_loss = self.evaluate()
                log.info("epoch %d eval loss: %f", epoch, eval_loss)
            if self.ckpt is not None and (
                    epoch % tcfg.save_per_epochs == 0
                    or epoch == epochs - 1):
                self.save()
            self.metrics.flush()
        return last_loss

    def _pull_metrics(self, m) -> float:
        """Pull one step's metrics to the host (the loop's device sync),
        NaN-guard and log them, with the trainer's throughput since the
        previous pull (host input, dispatch and device time together) in
        examples of the global batch."""
        loss = float(m["loss"])
        now = time.time()
        metrics_now = {"loss": loss, "grad_norm": float(m["grad_norm"])}
        finite_or_warn(metrics_now, self.global_step, log)
        self.metrics.add_scalar("Loss/train", loss, self.global_step)
        self.metrics.add_scalar("grad_norm", metrics_now["grad_norm"],
                                self.global_step)
        if self._tput_mark is not None:
            t0, s0 = self._tput_mark
            steps = self.global_step - s0
            if steps > 0 and now > t0:
                exs = steps * self.config.train.batch_size / (now - t0)
                self.metrics.add_scalar("examples_per_s", exs,
                                        self.global_step)
                log.info("step %d: loss %.5f, %.1f examples/s",
                         self.global_step, loss, exs)
        self._tput_mark = (now, self.global_step)
        return loss

    def evaluate(self, dataset=None, seed: int = 0) -> float:
        """Mean deterministic eval loss over a dataset (default: the train
        set), with a fixed noise/timestep stream per batch index so losses
        compare across checkpoints.  Each rank takes its rows of a batch,
        and every rank returns the global mean."""
        dataset = dataset if dataset is not None else self.dataset
        total, n = 0.0, 0
        for i, batch in enumerate(self._batches(
                dataset, self.config.train.batch_size)):
            loss = self._eval_fn(self._to_device(batch),
                                 eval_generator(self.device, seed, i))
            total += float(mean_over_ranks(loss))
            n += 1
        if n == 0:
            raise ValueError(
                f"evaluate(): dataset yielded no batches at batch_size="
                f"{self.config.train.batch_size} (len={len(dataset)})")
        loss = total / n
        self.metrics.add_scalar("Loss/eval", loss, self.global_step)
        self.metrics.flush()
        return loss
