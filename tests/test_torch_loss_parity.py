"""``tools/torch_loss_parity.py``: the port's ``Trainer`` against the JAX
trainer, side by side on the CPU.

The harness at 4 micro-steps (2 updates of ``--accum 2``, ``--ema 0.9``):
each loss and the final parameters within the step contract of
``tests/test_torch_train.py`` (``LOSS_TOL``, ``PARAM_ATOL``), the EMA with
them; and ``--ref`` refusing, before it runs anything, a saved run whose
step count, parameter names or shapes are not this run's.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tools")

# tests/test_torch_train.py's step contract: a loss to 1e-4, the parameters
# after AdamW updates at lr 1e-3 to 2e-3 per entry
LOSS_TOL, PARAM_ATOL = 1e-4, 2e-3
# the whole parameter vector and the EMA in relative L2 (measured 3.2e-5
# and 5.0e-6): f32 sums in another order, through two updates
PARAM_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    from torch_loss_parity import main
    path = str(tmp_path_factory.mktemp("parity") / "run.npz")
    return main(["--steps", "2", "--accum", "2", "--ema", "0.9",
                 "--save", path]), path


def test_losses_match_jax(saved):
    result, _ = saved
    assert result["steps"] == 4
    port, jax_ = (np.asarray(result[k]) for k in ("losses_port",
                                                   "losses_jax"))
    assert len(port) == len(jax_) == 4 and np.isfinite(port).all()
    assert np.abs(port - jax_).max() <= LOSS_TOL
    assert result["max_rel_loss_gap"] <= LOSS_TOL


def test_parameters_match_jax(saved):
    result, _ = saved
    assert result["param_max_abs"] <= PARAM_ATOL
    assert result["param_rel_l2"] <= PARAM_RTOL


def test_ema_matches_jax(saved):
    result, _ = saved
    assert result["ema"] == 0.9 and result["ema_rel_l2"] <= PARAM_RTOL


def test_save_holds_the_run(saved):
    result, path = saved
    ref = np.load(path)
    assert int(ref["steps"]) == 4
    np.testing.assert_array_equal(ref["losses_port"],
                                  np.asarray(result["losses_port"]))
    np.testing.assert_array_equal(ref["losses_jax"],
                                  np.asarray(result["losses_jax"]))
    assert sum(k.startswith("param/") for k in ref.files) > 20


def _resave(path, out, **change):
    ref = dict(np.load(path))
    for k, v in change.items():
        if v is None:
            ref.pop(k)
        else:
            ref[k] = v
    np.savez(out, **ref)
    return str(out)


NAME = "unet.conv_out.conv.weight"
# what each mismatched --ref changes, and the error it must raise
MISMATCHES = {
    "steps": ({}, "micro-steps, this run 6"),
    "missing": ({f"param/{NAME}": None}, f"missing \\['{NAME}'\\]"),
    "shape": ({f"param/{NAME}": np.zeros((8, 32, 4), np.float32)},
              f"{NAME} \\(8, 32, 4\\) != \\(8, 32, 3\\)"),
    "not_a_save": ({"steps": None}, "no step count"),
}


@pytest.mark.parametrize("case", list(MISMATCHES))
def test_ref_mismatch_raises_before_running(saved, tmp_path, case):
    """A ``--ref`` of another step count, another parameter set or shape,
    or not a save of this harness, raises naming the mismatch (before
    either trainer runs: each case takes well under a second)."""
    from torch_loss_parity import main
    _, path = saved
    change, message = MISMATCHES[case]
    ref = _resave(path, tmp_path / "ref.npz", **change)
    steps = "3" if case == "steps" else "2"
    with pytest.raises(ValueError, match=message):
        main(["--steps", steps, "--accum", "2", "--ref", ref])
