"""The hand-written kernels as ``torch.library`` ops (namespace ``ptts``).

Each of the six kernels' ops on its CPU implementation, the kernel's plain
version, at small shapes: ``torch.library.opcheck`` (the schema, the fake
implementation against the real one, autograd registration, the op
through AOT dispatch with dynamic shapes), the fake outputs' shapes, dtypes
and strides against the plain version's output, and the op bit-equal to
the eager wrapper on the same CPU tensors.  The CUDA implementations are
checked on the card (``tests/test_torch_cuda.py``).  Inputs come from a
numpy seed.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from prompt_tts_tpu_torch.models.unet1d import ResnetBlock1D
from prompt_tts_tpu_torch.ops.cuda.attention import flash_attention
from prompt_tts_tpu_torch.ops.cuda.attention_bwd import attention_bwd
from prompt_tts_tpu_torch.ops.cuda.lstm import (
    lstm_recurrence, lstm_recurrence_t,
)
from prompt_tts_tpu_torch.ops.cuda.resnet import (
    fused_resnet_block, pack_resnet_weights, packed_tensors,
)
from prompt_tts_tpu_torch.ops.cuda.rvq import rvq_encode
from prompt_tts_tpu_torch.pipeline import random_init_

OPS = ("flash_attention", "attention_bwd", "lstm_recurrence",
       "lstm_recurrence_t", "rvq_encode", "fused_resnet_block")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _attn_inputs(rng, dtype=torch.float32):
    q, k, v = (_t(rng, 2, T, 2, 32, dtype=dtype) for T in (5, 7, 7))
    bias = torch.zeros(2, 1, 1, 7)
    bias[1, ..., 4:] = -10000.0      # row 1's last keys padded
    return q, k, v, bias


def _resnet_case(dtype, cin=16, cout=32):
    """A seeded ResnetBlock1D, its packed weights, x and temb_proj."""
    block = ResnetBlock1D(cin, cout, 8, groups=8)
    random_init_(block, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in block.parameters():   # non-trivial norms and biases
            p.add_(0.1 * _t(rng, *p.shape))
    packed = pack_resnet_weights(block, dtype)
    return (_t(rng, 2, 6, cin, dtype=dtype), _t(rng, 2, cout), packed)


def _cases():
    """(op name, case id, op args, the eager wrapper's call)."""
    rng = np.random.default_rng(0)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias = _attn_inputs(rng, dtype)
        name = str(dtype)[6:]
        out.append(("flash_attention", name, (q, k, v, bias, False),
                    lambda q=q, k=k, v=v, b=bias: flash_attention(q, k, v,
                                                                  b)))
        out.append(("flash_attention", f"{name}-lse", (q, k, v, None, True),
                    None))
    q, k, v, bias = _attn_inputs(rng)
    o = flash_attention(q, k, v, bias)
    do = _t(rng, *q.shape)
    lse = torch.ops.ptts.flash_attention(q, k, v, bias, True)[1]
    for need in (False, True):
        out.append(("attention_bwd", f"dbias{int(need)}",
                    (q, k, v, o, do, bias, lse, need),
                    lambda n=need: attention_bwd(q, k, v, o, do, bias, lse,
                                                 need_dbias=n)))
    x_proj, H = _t(rng, 5, 3, 16), 4
    w_hh = 0.5 * _t(rng, H, 4 * H)
    out.append(("lstm_recurrence", "T5-B3", (x_proj, w_hh),
                lambda: lstm_recurrence(x_proj, w_hh)))
    w_t = w_hh.t().contiguous()
    out.append(("lstm_recurrence_t", "T5-B3", (x_proj, w_t),
                lambda: lstm_recurrence_t(x_proj, w_t)))
    emb, cb = _t(rng, 2, 5, 16), _t(rng, 3, 64, 16)
    out.append(("rvq_encode", "nq3", (emb, cb),
                lambda: rvq_encode(emb, cb)))
    for dtype, cin in ((torch.float32, 16), (torch.bfloat16, 16),
                       (torch.float32, 32)):
        x, tp, packed = _resnet_case(dtype, cin)
        case = f"{str(dtype)[6:]}-{cin}to32"
        out.append(("fused_resnet_block", case,
                    (x, tp, *packed_tensors(packed), 8, 1e-5),
                    lambda x=x, tp=tp, pk=packed: fused_resnet_block(
                        x, tp, pk, 8, 1e-5)))
    return out


CASES = _cases()
IDS = [f"{op}-{case}" for op, case, _, _ in CASES]
# the lse case has no eager CPU counterpart: the eager CPU path returns none
EAGER = [c for c in CASES if c[3] is not None]


def test_every_kernel_has_an_op():
    assert {op for op, _, _, _ in CASES} == set(OPS)
    for op in OPS:
        assert hasattr(torch.ops.ptts, op)


@pytest.mark.parametrize("op,case,args,eager", CASES, ids=IDS)
def test_opcheck(op, case, args, eager):
    torch.library.opcheck(getattr(torch.ops.ptts, op).default, args)


@pytest.mark.parametrize("op,case,args,eager", CASES, ids=IDS)
def test_fake_matches_the_plain_version(op, case, args, eager):
    """The fake implementation's outputs have the shapes, dtypes and
    strides of the CPU implementation's (the plain version's)."""
    fn = getattr(torch.ops.ptts, op)
    real = fn(*args)
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        fake = fn(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype)
        if r.numel():
            assert f.stride() == r.stride()


@pytest.mark.parametrize("op,case,args,eager", EAGER,
                         ids=[f"{op}-{case}" for op, case, _, _ in EAGER])
def test_op_is_the_eager_wrapper_on_the_cpu(op, case, args, eager):
    """On CPU tensors the op computes the eager wrapper's bits (its plain
    version)."""
    got = getattr(torch.ops.ptts, op)(*args)
    want = eager()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if w is None:
            assert g.numel() == 0
        else:
            assert torch.equal(g, w)


def test_lse_is_the_row_logsumexp():
    """The CPU op's lse is log sum exp of the scaled, biased f32 scores,
    the quantity the card's backward takes."""
    q, k, v, bias = _attn_inputs(np.random.default_rng(2))
    o, lse = torch.ops.ptts.flash_attention(q, k, v, bias, True)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) \
        * 32 ** -0.5 + bias.double()
    p = torch.softmax(s, -1)
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, -1),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(
        o.double(), torch.einsum("bhqk,bkhd->bqhd", p, v.double()),
        atol=1e-5, rtol=0)
