"""The deployment artifact's call wall, by how its programs are run, on the
card.

The flagship (``ModelConfig()``, bf16, seeded random weights) at batch 8,
DDIM-50, int16 PCM is exported with ``aot.export_synthesis`` with
``aot._strip_noops`` turned off (the graphs as ``torch.export`` traced
them; this first export in the process also pays the tracer's warm-up),
as it ships, and as it ships at DDIM-10 (the export's seconds do not
depend on the step count: one step program).  Then, in turns (the order
reversed every other round), one warm synthesis of each of:

* ``stripped``: the shipped artifact through ``aot.SynthesisProgram``;
* ``unstripped``: the unstripped artifact the same way;
* ``module``: the shipped artifact's programs run through
  ``ExportedProgram.module()`` in place of ``aot``'s own runner;
* ``live``: ``Synthesizer.synthesize`` on the same texts and seed.

Prints one JSON line: each route's walls, whether each gave the live
program's PCM and codes bit for bit, each export's stripped node counts
and its export and save seconds, and the card's name and power limit.

    python tools/torch_aot_call_ab.py [--rounds 3]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from prompt_tts_tpu_torch import aot  # noqa: E402
from prompt_tts_tpu_torch.diffusion.steps import (  # noqa: E402
    initial_noise, run_steps,
)
from prompt_tts_tpu_torch.pipeline import Synthesizer  # noqa: E402
from prompt_tts_tpu_torch.utils.precision import (  # noqa: E402
    denoise_scope, full_f32,
)

TEXTS = ["Hello from the port.", "Printing, in the only sense with which "
         "we are at present concerned.", "A third request.",
         "And a fourth, a little longer than the others."] * 2


def module_route(prog):
    """``prog``'s artifact run through ``ExportedProgram.module()``."""
    h = prog.header
    condition, step, finish = (prog.call.programs[n].module()
                               for n in aot.SECTIONS)
    coef = torch.tensor(h["coefficients"], dtype=torch.float32,
                        device="cuda")
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[h["dtype"]]

    @torch.no_grad()
    def run():
        ids, mask = (torch.as_tensor(a).cuda()
                     for a in prog.tokenizer.encode_batch(TEXTS))
        x_T = initial_noise(0, (len(TEXTS), h["sample_size"],
                                h["in_channels"])).cuda()
        with denoise_scope(dtype):
            lat = run_steps(step, condition(ids, mask), x_T,
                            h["timesteps"], coef, h["sampler"])
        with full_f32():
            wav, codes = finish(lat)
        return wav.cpu().numpy(), codes.cpu().numpy()
    return run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    synth = Synthesizer(device="cuda", dtype=torch.bfloat16,
                        num_inference_steps=50)
    strip = aot._strip_noops
    progs, exports = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, steps in (("unstripped", 50), ("stripped", 50),
                            ("stripped_ddim10", 10)):
            aot._strip_noops = (lambda ep: 0) if name == "unstripped" \
                else strip
            synth.num_inference_steps = steps
            path = os.path.join(tmp, f"{name}.ptts")
            h = aot.export_synthesis(synth, len(TEXTS), path)
            exports[name] = {"nodes_stripped": h["nodes_stripped"],
                             **h["seconds"]}
            if steps == 50:
                progs[name] = aot.SynthesisProgram(path)
    aot._strip_noops = strip
    synth.num_inference_steps = 50
    runs = {k: (lambda p=p: p.synthesize(TEXTS, seed=0, return_codes=True))
            for k, p in progs.items()}
    runs["module"] = module_route(progs["stripped"])
    runs["live"] = lambda: synth.synthesize(TEXTS, seed=0, pcm16=True,
                                            return_codes=True)
    outs = {k: f() for k, f in runs.items()}          # warm, and the bits
    bits = {k: bool(np.array_equal(v[0], outs["live"][0])
                    and np.array_equal(v[1], outs["live"][1]))
            for k, v in outs.items()}
    walls = {k: [] for k in runs}
    for r in range(args.rounds):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[k]()                                  # host numpy: synced
            walls[k].append(time.perf_counter() - t0)
    print(json.dumps({"tool": "torch_aot_call_ab", "what": "flagship bf16 "
                      "B=8 DDIM-50 pcm16, one warm synthesis a route",
                      "wall_s": walls, "bit_equal_to_live": bits,
                      "exports": exports, "card": smi}))


if __name__ == "__main__":
    main()
