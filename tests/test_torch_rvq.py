"""Residual-VQ encode: the PyTorch port against the JAX package.

The port's ``rvq_encode`` on CPU tensors (its plain version; the CUDA
kernel has no CPU mode and is held to it in ``test_torch_cuda.py``) against
JAX ``prompt_tts_tpu.codec.rvq.rvq_encode`` and against the TPU kernel
``rvq_encode_fused`` run in the Pallas interpreter.  Inputs come from
numpy seeds.  The contract is the codec's: bit-equal indices.  Also the
index contract that holds the kernel to the plain version
(``index_contract``), on crafted inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prompt_tts_tpu.codec.rvq import rvq_decode as jax_rvq_decode
from prompt_tts_tpu.codec.rvq import rvq_encode as jax_rvq_encode
from prompt_tts_tpu.ops.pallas.rvq import rvq_encode_fused
from prompt_tts_tpu_torch.codec.rvq import (
    codebook_decode, codebook_quantize, rvq_decode, rvq_encode,
)
from prompt_tts_tpu_torch.ops.cuda.rvq import (
    CODE_TILE, NEAR_TIE, RvqPlan, distances_tf32x3, index_contract,
    rvq_encode_plain, rvq_encode_tf32x3, rvq_plan, split_tf32, tf32_rna,
)


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "small":              # small K and D
        cb = rng.standard_normal((3, 32, 16))
        x = rng.standard_normal((2, 40, 16))
    elif name == "flagship":         # K = 1024, D = 128, n_q = 8 (6 kbps)
        cb = rng.standard_normal((8, 1024, 128))
        x = rng.standard_normal((2, 150, 128)) * 1.5
    elif name == "ragged":           # N = 3 * 23, not a multiple of 64
        cb = rng.standard_normal((2, 2 * CODE_TILE, 128))
        x = rng.standard_normal((3, 23, 128))
    elif name == "recovery":         # sums of codes, as test_codec_vs_torch
        cb0 = rng.normal(size=(16, 4)) * 10.0
        cb1 = rng.normal(size=(16, 4)) * 0.1
        cb = np.stack([cb0, cb1])
        idx = rng.integers(0, 16, size=(2, 1, 5))
        x = cb0[idx[0]] + cb1[idx[1]]
    else:                            # duplicated rows: the first must win
        cb = rng.standard_normal((2, 64, 8))
        cb[1] *= 0.1
        cb[:, 40] = cb[:, 3]
        cb[:, 63] = cb[:, 3]
        cb[1, 10] = cb[1, 9]
        x = np.concatenate([cb[0, 3][None], cb[0, 9][None] + cb[1, 9][None],
                            rng.standard_normal((6, 8))])[None]
    return x.astype(np.float32), cb.astype(np.float32)


CASES = ["small", "flagship", "ragged", "recovery", "duplicates"]


@pytest.mark.parametrize("name", CASES)
def test_rvq_encode_equals_jax_and_fused_kernel(name):
    x, cb = _case(name)
    out = rvq_encode(torch.from_numpy(x), torch.from_numpy(cb))
    ref = np.asarray(jax_rvq_encode(jnp.asarray(x), jnp.asarray(cb)))
    fused = np.asarray(rvq_encode_fused(jnp.asarray(x), jnp.asarray(cb),
                                        interpret=True))
    assert out.dtype == torch.int32
    assert out.shape == (x.shape[0], cb.shape[0], x.shape[1])
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), fused)
    if name == "duplicates":
        assert out[0, 0, 0] == 3                          # not 40 or 63
        assert out[0, 0, 1] == 9 and out[0, 1, 1] == 9    # not 10
    if name == "recovery":
        # exact recovery: the codes rebuild x, as in test_codec_vs_torch
        xq = rvq_decode(out, torch.from_numpy(cb))
        np.testing.assert_allclose(xq.numpy(), x, atol=1e-5)
        np.testing.assert_array_equal(
            xq.numpy(), np.asarray(jax_rvq_decode(jnp.asarray(out.numpy()),
                                                  jnp.asarray(cb))))


def test_codebook_quantize_and_decode():
    x, cb = _case("small")
    idx = codebook_quantize(torch.from_numpy(x), torch.from_numpy(cb[0]))
    assert idx.shape == x.shape[:-1]
    d = ((x[..., None, :] - cb[0]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx.numpy(), d.argmin(-1))
    np.testing.assert_array_equal(
        codebook_decode(idx, torch.from_numpy(cb[0])).numpy(), cb[0][idx])


def test_index_contract_accepts_ties_and_refuses_the_rest():
    """A flip between two equal codes is a near-tie; a flip to a far code
    is a violation; identical encodings have no difference at all."""
    x, cb = _case("duplicates")
    xt, cbt = torch.from_numpy(x), torch.from_numpy(cb)
    ref = rvq_encode_plain(xt, cbt)
    same = index_contract(xt, cbt, ref, ref)
    assert same == {"vectors": 8, "differ": 0, "violations": 0,
                    "max_score_gap": 0.0, "worst_gap_over_limit": 0.0}
    tie = ref.clone()
    tie[0, 0, 0] = 40            # the duplicate of code 3: an exact tie
    r = index_contract(xt, cbt, tie, ref)
    assert r["differ"] == 1 and r["violations"] == 0
    far = ref.clone()
    far[0, 1, 4] = (far[0, 1, 4] + 17) % 64
    r = index_contract(xt, cbt, far, ref)
    assert r["differ"] == 1 and r["violations"] == 1
    assert r["worst_gap_over_limit"] > 1.0


def test_wrapper_checks_shapes():
    x, cb = _case("small")
    with pytest.raises(ValueError, match="codebook dim"):
        rvq_encode(torch.from_numpy(x), torch.from_numpy(cb[..., :8]))
    with pytest.raises(ValueError, match=r"\[B,T,D\]"):
        rvq_encode(torch.from_numpy(x[0]), torch.from_numpy(cb))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The flagship-size products run on one torch thread: tier-1 shares
    the cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tf32_rounding_is_cvt_rna():
    """To nearest, ties away from zero, the low 13 bits cleared; the split
    recovers x to ~2^-22 relative."""
    u = 2.0 ** -10                       # a TF32 ulp at 1
    x = torch.tensor([1.0, 1 + u / 2, 1 + u / 4, 1 + 3 * u / 4, -(1 + u / 2),
                      3.14159265, -0.0, 6.5e-39], dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([1.0, 1 + u, 1.0, 1 + u, -(1 + u), 3.140625, -0.0,
                         6.5e-39], dtype=torch.float32)
    want[-1] = tf32_rna(want[-1:])[0]    # a denormal keeps 10 bits too
    assert torch.equal(got.view(torch.int32) & 0x1FFF,
                       torch.zeros(8, dtype=torch.int32))
    assert torch.equal(got, want)
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096).astype(np.float32))
    hi, lo = split_tf32(r)
    assert ((hi.double() + lo.double() - r.double()).abs()
            <= 2.0 ** -21 * r.double().abs()).all()


def test_tf32x3_scores_and_indices_at_flagship_size():
    """The kernel's arithmetic at K = 1024, D = 128 over 3 layers on 2,048
    seeded vectors: each distance within NEAR_TIE / 10 of (|r| + |e|)^2 of
    the f64 one (one TF32 product, for contrast, is beyond NEAR_TIE), and
    its indices hold the index contract against the plain version with no
    violation."""
    _, cb = _case("flagship")
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((4, 512, 128)) * 1.5).astype(np.float32)
    xt, cbt = torch.from_numpy(x), torch.from_numpy(cb[:3])
    r = xt.reshape(-1, 128)
    worst = worst_one = 0.0
    for e in cbt:
        d = distances_tf32x3(r, e, torch.sum(e * e, dim=1)).double()
        rd, ed = r.double(), e.double()
        d64 = ((rd * rd).sum(1, keepdim=True) - 2.0 * rd @ ed.T
               + (ed * ed).sum(1)[None])
        scale = (rd.norm(dim=1)[:, None] + ed.norm(dim=1)[None]) ** 2
        worst = max(worst, float(((d - d64).abs() / scale).max()))
        one = ((r * r).sum(1, keepdim=True) - 2.0 * tf32_rna(r) @ tf32_rna(e).T
               + (e * e).sum(1)[None]).double()
        worst_one = max(worst_one, float(((one - d64).abs() / scale).max()))
        r = r - e[torch.argmin(d, dim=1)]
    assert worst <= NEAR_TIE / 10, worst
    assert worst_one > NEAR_TIE, worst_one
    got = rvq_encode_tf32x3(xt, cbt)
    assert got.dtype == torch.int32 and got.shape == (4, 3, 512)
    rep = index_contract(xt, cbt, got, rvq_encode_plain(xt, cbt))
    assert rep["violations"] == 0, rep


@pytest.mark.parametrize("N, want", [
    (32 * 900, RvqPlan(128, 1, 225)),   # the encode slice: 2 warpgroups
    (4 * 225, RvqPlan(64, 8, 120)),     # the prompt encode: a cluster of 8
    (1 * 225, RvqPlan(64, 8, 32)),      # one prompt
    (3 * 333, RvqPlan(64, 8, 128)),     # ragged: 15 full tiles and 39
    (8000, RvqPlan(64, 2, 250)),        # 125 tiles: 2 cover the SMs
    (132 * 128, RvqPlan(128, 1, 132)),  # 128-row tiles just fill them
])
def test_rvq_plan_at_the_path_shapes(N, want):
    assert rvq_plan(N, 8, 1024) == want
    assert rvq_plan(N, 32, 1024) == want    # n_q does not move the grid


def test_rvq_plan_cluster_divides_the_codes_and_refuses_the_rest():
    # K / cluster must be whole 64-code tiles: 192 codes only split by 1,
    # 128 by 2
    assert rvq_plan(900, 8, 192) == RvqPlan(64, 1, 15)
    assert rvq_plan(900, 8, 128) == RvqPlan(64, 2, 30)
    assert rvq_plan(900, 8, 1024, sms=16).cluster == 2
    for N, n_q, K in ((0, 8, 1024), (900, 0, 1024), (900, 8, 1000),
                      (900, 8, 0)):
        with pytest.raises(ValueError, match="multiple of 64"):
            rvq_plan(N, n_q, K)
