"""Ahead-of-time synthesis-program export (deployment artifacts).

Port of ``prompt_tts_tpu/aot.py``.  The synthesis device program --
``(x_T, text_ids, text_mask[, prompt_latents]) -> (pcm16 | f32 wav,
codes)`` -- is exported with ``torch.export`` as three programs, the
pieces ``pipeline.Synthesizer`` itself runs:

* **condition** (``pipeline.ConditionProgram``): ids, mask [, prompt] ->
  the hoisted cross-attention k/v (and the speaker embedding), the
  classifier-free guidance null branch included;
* **step** (``pipeline.StepProgram``): one sampler step, the UNet's eps
  under guidance and one DDIM or DPM-Solver++(2M) update on the step's
  table row; exported once, so the export's cost does not grow with the
  number of steps: the loader runs it over the header's tables
  (``diffusion.steps.run_steps``, the live loop);
* **finish** (``pipeline.FinishProgram``): latents -> codes -> the codec's
  decode -> int16 PCM (or f32 wav).

Each program's weights are its module's state (parameters and buffers,
the resnet blocks' packed kernel weights among them), which
``torch.export.save`` stores beside the graph and the loaded program takes
as arguments, never as constants.  The graphs hold the hand-written
kernels as the ``ptts`` ops (``ops/cuda/library.py``) and otherwise eager
ATen ops, so a loaded artifact runs the live program's kernels and gives
its bits.  The loader enters :func:`~prompt_tts_tpu_torch.utils.precision.
full_f32` around the same pieces as the live program (a graph does not
record the TF32 flags): the condition and steps of an f32 denoiser, and
every decode.

A serving process ``load_synthesis(path)``s the artifact with no model
code, config or checkpoint: this module imports only the kernels' ops, the
sampler loop and, in :class:`SynthesisProgram`, the tokenizer.

Artifact layout (one file): ``b"PTTSPT01"`` magic (the JAX package's
artifacts start ``PTTSAOT1``; neither loader takes the other's), a
little-endian u32 header length, a JSON header (format version 1: shapes,
sampler, steps, guidance, dtypes, the device type, the torch version, the
sampler's timestep and coefficient tables, each section's size), then the
condition, step and finish programs' ``torch.export.save`` bytes.
"""

import io
import json
import struct
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.export.graph_signature import InputKind, OutputKind

# the kernels' ops must exist before a program holding them is loaded
from prompt_tts_tpu_torch.ops.cuda import (  # noqa: F401
    attention, attention_bwd, lstm, resnet, rvq,
)
from prompt_tts_tpu_torch.diffusion.steps import initial_noise, run_steps
from prompt_tts_tpu_torch.utils.precision import denoise_scope, full_f32

_MAGIC = b"PTTSPT01"
_VERSION = 1
SECTIONS = ("condition", "step", "finish")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _zeros_like_outputs(ep, device) -> list:
    """Zero tensors shaped as ``ep``'s outputs (from the graph's fake
    values, without running it): the next program's example inputs."""
    out = next(n for n in ep.graph.nodes if n.op == "output")
    return [torch.zeros(a.meta["val"].shape, dtype=a.meta["val"].dtype,
                        device=device) for a in out.args[0]]


def _strip_noops(ep) -> int:
    """Remove from ``ep``'s graph, in place, what tracing records and an
    eager call never executes: each ``aten.to`` to the dtype its input
    already has (eager returns the input itself), each eval-mode
    ``aten.dropout`` (the input itself), and each
    ``aten._assert_tensor_metadata`` check.  The rest of the graph, and so
    its bits, are the same; the loaded program makes that many fewer host
    calls a run.  Returns the count removed."""
    aten = torch.ops.aten
    removed = 0
    for node in list(ep.graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is aten._assert_tensor_metadata.default:
            ep.graph.erase_node(node)
            removed += 1
            continue
        if any(u.op == "output" for u in node.users):
            continue          # the signature names it: keep it
        if node.target is aten.to.dtype:
            src = node.args[0].meta["val"]
            kw = dict(zip(("non_blocking", "copy", "memory_format"),
                          node.args[2:]), **node.kwargs)
            alias = (src.dtype == node.args[1] and not kw.get("copy")
                     and kw.get("memory_format") in (
                         None, torch.preserve_format))
        elif node.target is aten.dropout.default:
            alias = not node.args[2]
        else:
            continue
        if alias:
            node.replace_all_uses_with(node.args[0])
            ep.graph.erase_node(node)
            removed += 1
    ep.graph_module.recompile()
    return removed


def export_synthesis(synth, batch_size: int, path: str,
                     pcm16: bool = True) -> dict:
    """Export ``synth``'s synthesis program at ``batch_size`` to ``path``.

    ``synth``: a :class:`~prompt_tts_tpu_torch.pipeline.Synthesizer`; its
    programs are exported on its device as they are (its weights ship as
    their state).  ``pcm16``: the device-quantized int16 program (the
    serving wire format) instead of the f32 wav.  Returns the header, with
    the export's, and the save's, seconds under ``"seconds"``.  A
    ``Synthesizer`` sharded over a model group (``synth.tp > 1``) or a
    seq group (``synth.sp > 1``) raises ``ValueError``, as the JAX package
    refuses a meshed one.
    """
    for what, size in (("model-group-sharded Synthesizer (tp)",
                        getattr(synth, "tp", 1)),
                       ("seq-group-sharded Synthesizer (sp)",
                        getattr(synth, "sp", 1))):
        if size > 1:
            raise ValueError(
                f"cannot export a {what}: the traced program contains "
                "collectives over a process group the loading process "
                "would have to reconstruct; export from an unsharded "
                "Synthesizer (the artifact is single-device)")
    mcfg = synth.config.model
    dev = synth.device
    B = batch_size
    ids = torch.zeros((B, mcfg.cmu_seq_len), dtype=torch.int32, device=dev)
    mask = torch.ones_like(ids)
    cond_args = (ids, mask)
    if synth.prompted:
        cond_args += (torch.zeros((B, mcfg.prompt_frames, mcfg.in_channels),
                                  device=dev),)
    ts, coef = synth.sampler_tables()
    x = torch.zeros((B, mcfg.sample_size, mcfg.in_channels), device=dev)
    state = (x, x.clone()) if synth.sampler == "dpm" else (x,)
    t = torch.zeros((B,), dtype=torch.long, device=dev)
    row = torch.from_numpy(coef[0]).to(dev)
    seconds = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        with denoise_scope(synth.dtype):
            cond_ep = torch.export.export(synth.condition_program(),
                                          cond_args, strict=False)
            cond = tuple(_zeros_like_outputs(cond_ep, dev))
            step_ep = torch.export.export(synth.step_program(),
                                          (t, row, cond, state),
                                          strict=False)
        finish_ep = torch.export.export(synth.finish_program(pcm16),
                                        (x,), strict=False)
    stripped = {name: _strip_noops(ep) for name, ep in
                zip(SECTIONS, (cond_ep, step_ep, finish_ep))}
    seconds["export"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blobs = []
    for ep in (cond_ep, step_ep, finish_ep):
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        blobs.append(buf.getvalue())
    header = {
        "version": _VERSION,
        "batch_size": B,
        "pcm16": bool(pcm16),
        "prompted": bool(synth.prompted),
        "sampler": synth.sampler,
        "num_inference_steps": synth.num_inference_steps,
        "guidance_scale": synth.guidance_scale,
        "dtype": _dtype_name(synth.dtype),
        "codec_dtype": _dtype_name(synth.codec_fast.codec.dtype),
        "sample_rate": 24000,
        "sample_size": mcfg.sample_size,
        "in_channels": mcfg.in_channels,
        "cmu_seq_len": mcfg.cmu_seq_len,
        "prompt_frames": mcfg.prompt_frames if synth.prompted else 0,
        "device": dev.type,
        "torch_version": torch.__version__,
        "timesteps": [int(v) for v in ts],
        # f32 values written as the doubles they are: they load bit-exact
        "coefficients": coef.astype(np.float64).tolist(),
        "sections": {name: len(b) for name, b in zip(SECTIONS, blobs)},
        "nodes_stripped": stripped,
    }
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for b in blobs:
            f.write(b)
    seconds["save"] = time.perf_counter() - t0
    return dict(header, seconds=seconds)


def _check_device(header: dict) -> None:
    """Fail fast with an actionable message when the artifact was exported
    for a device type this process does not have (a ``cuda`` artifact in a
    process without a CUDA device), instead of a low-level error while its
    weights load."""
    device = header.get("device")
    have = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cpu" or device == have:
        return
    raise ValueError(
        f"artifact was exported for device {device!r} but the current "
        f"backend is {have!r}; re-export with --device {have}")


def _runner(ep):
    """``ep``'s graph as a callable of the exported inputs: its lifted
    state (parameters, buffers, constants) bound once, the inputs flattened
    as the export flattened them, the outputs unflattened.  ``ep.module()``
    runs the same graph behind per-call guards that re-read the program's
    call graph, which cost the flagship's step program several times its
    own host time on the card (PERF.md, the deployment export)."""
    sig = ep.graph_signature
    if any(o.kind != OutputKind.USER_OUTPUT for o in sig.output_specs):
        raise ValueError("an artifact program mutates its state")
    state = {**ep.state_dict, **ep.constants}
    slots = [None if s.kind == InputKind.USER_INPUT else state[s.target]
             for s in sig.input_specs]
    user = [i for i, s in enumerate(sig.input_specs)
            if s.kind == InputKind.USER_INPUT]
    spec = ep.call_spec
    in_spec, out_spec, gm = spec.in_spec, spec.out_spec, ep.graph_module

    def run(*args):
        flat, got = pytree.tree_flatten((args, {}))
        if got != in_spec:
            raise ValueError(f"artifact program inputs {got} do not match "
                             f"the exported {in_spec}")
        ins = list(slots)
        for i, a in zip(user, flat):
            ins[i] = a
        return pytree.tree_unflatten(gm(*ins), out_spec)

    return run


def read_artifact(path: str) -> Tuple[dict, dict]:
    """``(header, sections)`` of an artifact, each section's
    ``torch.export.save`` bytes by name; checks the magic, the version and
    the device (:func:`_check_device`) first."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a ptts torch AOT artifact "
                             f"(magic {magic!r})")
        (hdr_len,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hdr_len).decode("utf-8"))
        if header.get("version") != _VERSION:
            raise ValueError(
                f"{path}: artifact format version "
                f"{header.get('version')!r} is not supported by this "
                f"build (expected {_VERSION}); re-export it with the "
                "current prompt_tts_tpu_torch")
        _check_device(header)
        blobs = {name: f.read(header["sections"][name]) for name in SECTIONS}
    return header, blobs


def load_synthesis(path: str) -> Tuple[object, dict]:
    """Load an artifact; returns ``(call, header)``.

    ``call(x_T, ids, mask[, prompt])`` runs the program on the artifact's
    device (tensors of the exported shapes there: x_T ``[B, sample_size,
    in_channels]`` f32, ids/mask ``[B, cmu_seq_len]`` int32, prompt
    latents ``[B, prompt_frames, in_channels]`` f32) and returns ``(wav,
    codes)`` on the device; the shipped weights are already bound.
    ``call.programs`` holds the three ``ExportedProgram``s by name.
    """
    header, blobs = read_artifact(path)
    programs = {name: torch.export.load(io.BytesIO(b))
                for name, b in blobs.items()}
    condition, step, finish = (_runner(programs[n]) for n in SECTIONS)
    device = torch.device(header["device"])
    dtype = _DTYPES[header["dtype"]]
    ts = header["timesteps"]
    coef = torch.tensor(header["coefficients"], dtype=torch.float32,
                        device=device)
    B, T, C = (header[k] for k in ("batch_size", "sample_size",
                                   "in_channels"))
    want = {"x_T": ((B, T, C), torch.float32),
            "ids": ((B, header["cmu_seq_len"]), torch.int32),
            "mask": ((B, header["cmu_seq_len"]), torch.int32),
            "prompt": ((B, header["prompt_frames"], C), torch.float32)}

    @torch.no_grad()
    def call(x_T, ids, mask, prompt=None):
        if (prompt is not None) != header["prompted"]:
            raise ValueError("a prompted artifact takes prompt latents, "
                             "an unprompted one none")
        for name, a in (("x_T", x_T), ("ids", ids), ("mask", mask),
                        ("prompt", prompt)):
            shape, dt = want[name]
            if a is not None and (tuple(a.shape) != shape or a.dtype != dt
                                  or a.device.type != device.type):
                raise ValueError(
                    f"{name}: {tuple(a.shape)} {a.dtype} on {a.device}, the "
                    f"artifact takes {shape} {dt} on {device.type}")
        with denoise_scope(dtype):
            cond = condition(ids, mask,
                             *(() if prompt is None else (prompt,)))
            latents = run_steps(step, cond, x_T, ts, coef,
                                header["sampler"])
        with full_f32():
            return finish(latents)

    call.programs = programs
    return call, header


class SynthesisProgram:
    """Text -> wav over a loaded artifact: the deployment serving object.

    Rebuilds only the host stages around the device programs -- the port's
    tokenizer (pure Python + the bundled CMU dictionary), x_T drawn from
    ``seed`` as ``Synthesizer.noise`` draws it (a CPU ``torch.Generator``),
    and the prompt padded or cropped to ``prompt_frames`` -- as
    ``Synthesizer`` does.  No model code, config or checkpoint is touched.
    """

    def __init__(self, path: str):
        self.call, self.header = load_synthesis(path)
        from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer
        self.tokenizer = Tokenizer(max_len=self.header["cmu_seq_len"])
        self.device = torch.device(self.header["device"])

    @property
    def batch_size(self) -> int:
        return self.header["batch_size"]

    def _upload(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def synthesize(self, texts: Sequence[str], seed: int = 0,
                   prompt_latents: Optional[np.ndarray] = None,
                   return_codes: bool = False):
        """texts (exactly ``batch_size`` of them; pad with "") -> wav as
        host numpy, int16 PCM or f32 per the artifact's ``pcm16``; with
        ``return_codes`` also the codes ``[B, n_q, frames]``.  A prompted
        artifact takes ``prompt_latents`` ``[B, T, in_channels]`` for any
        T, zero-padded or cropped to ``prompt_frames`` as the live
        ``Synthesizer.prompt_latents`` does (``pipeline.codes_to_latents``
        makes latents of codes)."""
        h = self.header
        B = h["batch_size"]
        if len(texts) != B:
            raise ValueError(f"artifact is batch-{B}; got {len(texts)} "
                             "texts (pad with empty strings)")
        ids, mask = self.tokenizer.encode_batch(list(texts))
        x_T = initial_noise(seed, (B, h["sample_size"], h["in_channels"]))
        args = [self._upload(x_T), self._upload(ids), self._upload(mask)]
        if h["prompted"]:
            if prompt_latents is None:
                raise ValueError("prompted artifact needs prompt_latents")
            prompt = np.asarray(prompt_latents, np.float32)
            Tp = h["prompt_frames"]
            fixed = np.zeros((prompt.shape[0], Tp, h["in_channels"]),
                             np.float32)
            fixed[:, : min(Tp, prompt.shape[1])] = prompt[:, :Tp]
            args.append(self._upload(fixed))
        wav, codes = self.call(*args)
        wav = wav.cpu().numpy()
        if return_codes:
            return wav, codes.cpu().numpy()
        return wav
