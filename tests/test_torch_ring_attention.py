"""Ring attention: the port's ring over gloo ranks on the CPU against JAX's.

The port of ``tests/test_ring_attention.py`` for ``prompt_tts_tpu_torch``.
Four worker processes join one process group (the ``PTTS_*`` variables)
and lay it out twice: one seq group of 4 (sp 4), then two seq groups of 2
(sp 2).  Each rank runs ``ops.ring_attention`` (the autograd function the
card runs on kernels #1 and #2, here on the blocks' plain versions, which
take the whole row's lse as the kernels do), ``ring_attention_plain``
(JAX's online-softmax loop) and the dispatcher under
``sp.sequence_parallel`` on its time slice of the same inputs, forward and
backward against one upstream gradient.  This process holds the joined
slices to JAX ``ring_attention`` under ``shard_map`` on as many virtual
devices, to JAX's full attention (``_xla_attention``), and the gradients
to ``jax.grad`` of the JAX ring.

Cases: ``test_ring_attention.py``'s (T, D) = (128, 32) and (256, 16) at
B=2, H=4, and its key-bias case (B=1, T=128, H=2, D=16, the last quarter
of the keys masked by -1e9).  Tolerances: the forward 2e-5 absolute
(JAX's own), the gradients 2e-5 absolute plus 1e-5 of their largest
magnitude, the row log-sum-exp 1e-5 of the f64 one.
"""

import os
import random
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map            # jax >= 0.8
except ImportError:                      # pragma: no cover
    from jax.experimental.shard_map import shard_map

from prompt_tts_tpu.ops.attention import _xla_attention
from prompt_tts_tpu.ops.ring_attention import ring_attention as jax_ring

FWD_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL_OF_MAX = 2e-5, 1e-5
LSE_RTOL = 1e-5
RANKS = 4
CASES = {"T128_D32": (2, 128, 4, 32, False),
         "T256_D16": (2, 256, 4, 16, False),
         "bias": (1, 128, 2, 16, True)}

# the ranks' program; its arguments come in ``spec.pt``, its results go to
# ``rank<r>.pt``.  It must load no module of JAX.
_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
from prompt_tts_tpu_torch import parallel
from prompt_tts_tpu_torch.ops.attention import scaled_dot_product_attention
from prompt_tts_tpu_torch.ops.ring_attention import (
    ring_attention, ring_attention_plain,
)
from prompt_tts_tpu_torch.parallel import sp

out = sys.argv[1]
spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
parallel.init_distributed("cpu")
w = parallel.world_rank()
res = {}
for n_seq in (4, 2):
    parallel.set_mesh(1, n_seq)
    seq = sp.mesh_seq()
    res[n_seq] = {"seq": (seq.rank, seq.size, seq.ranks)}
    for name, case in spec["cases"].items():
        T = case["q"].shape[1]
        n = T // n_seq
        mine = lambda x: x[:, seq.rank * n:(seq.rank + 1) * n].clone()
        q, k, v, do = (mine(case[x]) for x in ("q", "k", "v", "do"))
        bias = case["bias"]
        bias = None if bias is None else mine(bias.transpose(1, 3)
                                              ).transpose(1, 3).contiguous()
        got = {}
        for label, fn in (("ring", ring_attention),
                          ("plain", ring_attention_plain)):
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            o, lse = fn(qq, kk, vv, bias, seq, return_lse=True)
            o.backward(do)
            got[label] = {"o": o.detach(), "lse": lse.detach(),
                          "dq": qq.grad, "dk": kk.grad, "dv": vv.grad}
        sp.reset_ring_traces()
        with sp.sequence_parallel(seq):
            got["dispatch"] = {"o": scaled_dot_product_attention(q, k, v,
                                                                 bias)}
        got["tqs"] = sp.ring_trace_tqs()
        # cross-attention shapes are not the ring's
        with sp.sequence_parallel(seq):
            scaled_dot_product_attention(q, k[:, :n // 2], v[:, :n // 2])
        got["tqs_after_cross"] = sp.ring_trace_tqs()
        got["count"] = sp.ring_trace_count()
        res[n_seq][name] = got
res["jax_free"] = sorted({m.split(".")[0] for m in sys.modules} & {
    "jax", "flax", "optax", "prompt_tts_tpu"})
parallel.barrier()
torch.distributed.destroy_process_group()
torch.save(res, os.path.join(out, f"rank{w}.pt"))
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    """A port that binds now, drawn below Linux's ephemeral range (32768
    up): a port the kernel hands out (``bind`` to 0) can be taken by an
    outgoing connection of another rank before its server binds it."""
    while True:
        port = random.SystemRandom().randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def _inputs():
    rng = np.random.default_rng(0)
    cases = {}
    for name, (B, T, H, D, masked) in CASES.items():
        q, k, v, do = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                       for _ in range(4))
        bias = None
        if masked:
            bias = np.where(np.arange(T) < 3 * T // 4, 0.0, -1e9).astype(
                np.float32)[None, None, None, :].repeat(B, 0)
        cases[name] = {"q": q, "k": k, "v": v, "do": do, "bias": bias}
    return cases


def _jax_ring(n, q, k, v, bias):
    """JAX ``ring_attention`` under ``shard_map`` over the first ``n``
    devices, and ``jax.vjp`` of it."""
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("sp",))
    if bias is None:
        fn = shard_map(
            lambda q_, k_, v_: jax_ring(q_, k_, v_, axis_name="sp",
                                        axis_size=n),
            mesh=mesh, in_specs=(P(None, "sp"),) * 3,
            out_specs=P(None, "sp"))
        return jax.jit(lambda q_, k_, v_: jax.vjp(fn, q_, k_, v_))
    key_bias = bias[:, 0, 0, :]
    fn = shard_map(
        lambda q_, k_, v_, b_: jax_ring(q_, k_, v_, axis_name="sp",
                                        axis_size=n, key_bias=b_),
        mesh=mesh, in_specs=(P(None, "sp"),) * 4, out_specs=P(None, "sp"))
    return jax.jit(lambda q_, k_, v_: jax.vjp(
        lambda a, b, c: fn(a, b, c, key_bias), q_, k_, v_))


def _jax_ring_results(n, c):
    """JAX's ring over ``n`` devices on case ``c``: its output and the
    gradients of q, k and v against the case's upstream gradient."""
    bias = None if c["bias"] is None else jnp.asarray(c["bias"])
    q, k, v, do = (jnp.asarray(c[x]) for x in ("q", "k", "v", "do"))
    o, vjp = _jax_ring(n, q, k, v, bias)(q, k, v)
    dq, dk, dv = vjp(do)
    return {"o": np.asarray(o), "dq": np.asarray(dq), "dk": np.asarray(dk),
            "dv": np.asarray(dv)}


def _jax_full_results(c):
    """JAX's full attention on case ``c`` and the f64 row log-sum-exp."""
    bias = None if c["bias"] is None else jnp.asarray(c["bias"])
    full = np.asarray(_xla_attention(*(jnp.asarray(c[x])
                                       for x in ("q", "k", "v")), bias))
    s = np.einsum("bqhd,bkhd->bhqk", c["q"].astype(np.float64),
                  c["k"].astype(np.float64)) * c["q"].shape[-1] ** -0.5
    if c["bias"] is not None:
        s = s + c["bias"].astype(np.float64)
    mx = s.max(-1, keepdims=True)
    lse = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    return {"full": full, "lse": lse}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the ranks, compute JAX's results meanwhile, and return both."""
    out = tmp_path_factory.mktemp("ring")
    cases = _inputs()
    spec = {"cases": {name: {k: None if v is None else torch.from_numpy(v)
                             for k, v in c.items()}
                      for name, c in cases.items()}}
    torch.save(spec, out / "spec.pt")
    (out / "worker.py").write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": (os.environ.get("PYTHONPATH", "") + ":" + repo)
           .lstrip(":")}
    procs = [subprocess.Popen(
        [sys.executable, str(out / "worker.py"), str(out)],
        env={**env, "PTTS_COORDINATOR": f"127.0.0.1:{port}",
             "PTTS_NUM_PROCESSES": str(RANKS), "PTTS_PROCESS_ID": str(r)},
        cwd=out, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    try:
        # the JAX compiles overlap: XLA releases the interpreter lock
        with ThreadPoolExecutor(len(cases) * 2) as pool:
            jobs = {(name, n): pool.submit(_jax_ring_results, n, c)
                    for name, c in cases.items() for n in (2, 4)}
            ref = {name: _jax_full_results(c) for name, c in cases.items()}
            for (name, n), job in jobs.items():
                ref[name].setdefault("ring", {})[n] = job.result()
        outs = []
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} failed:\n{text[-3000:]}"
              for r, (p, text) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    return {"ref": ref, "ranks": ranks}


def _joined(run, n_seq, name, label, key, dim=1):
    """The ranks of the first seq group's slices joined along time."""
    parts = [run["ranks"][r][n_seq][name][label][key] for r in range(n_seq)]
    return torch.cat(parts, dim=dim).numpy()


def test_seq_groups_lay_out(run):
    """World rank w sits at seq position w % n_seq, its group the ranks of
    its block of n_seq."""
    for w, res in enumerate(run["ranks"]):
        assert res[4]["seq"] == (w, 4, (0, 1, 2, 3))
        base = w - w % 2
        assert res[2]["seq"] == (w % 2, 2, (base, base + 1))
        assert res["jax_free"] == []


@pytest.mark.parametrize("n_seq", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax_ring_and_full(run, n_seq, name):
    """The ring's output and its plain loop's equal JAX's ring under
    ``shard_map`` and JAX's full attention within 2e-5; the dispatcher
    under ``sequence_parallel`` rings once (a cross-attention call does
    not) and gives the ring's bits; its row
    log-sum-exp is the whole row's (1e-5 of the f64 one); the seq groups
    of the sp 2 layout agree."""
    ref = run["ref"][name]
    for label in ("ring", "plain"):
        o = _joined(run, n_seq, name, label, "o")
        np.testing.assert_allclose(o, ref["ring"][n_seq]["o"], atol=FWD_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(o, ref["full"], atol=FWD_ATOL, rtol=0)
        lse = _joined(run, n_seq, name, label, "lse", dim=2)
        np.testing.assert_allclose(lse, ref["lse"], rtol=LSE_RTOL, atol=0)
    np.testing.assert_array_equal(_joined(run, n_seq, name, "dispatch", "o"),
                                  _joined(run, n_seq, name, "ring", "o"))
    T = CASES[name][1]
    for r in range(n_seq):
        got = run["ranks"][r][n_seq][name]
        assert got["tqs"] == [T]
        assert got["tqs_after_cross"] == [T]
        assert got["count"] == 1
    if n_seq == 2:
        for key in ("o", "dq", "dk", "dv"):
            for r in (0, 1):
                assert torch.equal(run["ranks"][r][2][name]["ring"][key],
                                   run["ranks"][r + 2][2][name]["ring"][key])


@pytest.mark.parametrize("n_seq", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_ring_gradients_match_jax_grad(run, n_seq, name):
    """dq, dk and dv of the ring (the blocks' backward on the merged lse,
    dk/dv carried home around the ring) and of its plain loop (autograd
    through the rotations) against ``jax.vjp`` of JAX's ring on the same
    upstream gradient: 2e-5 plus 1e-5 of the largest magnitude."""
    ref = run["ref"][name]["ring"][n_seq]
    for label in ("ring", "plain"):
        for key in ("dq", "dk", "dv"):
            got = _joined(run, n_seq, name, label, key)
            want = ref[key]
            tol = GRAD_ATOL + GRAD_RTOL_OF_MAX * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                       err_msg=f"{label} {key}")
