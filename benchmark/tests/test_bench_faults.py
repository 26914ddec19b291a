"""A run with the timed path broken underneath comes out not correct:
each fault of ``lib/faults.py`` planted in the port, at a tiny size on
the CPU, against the cells' limits."""
import pytest

from benchmark.runners import envdrop_spcl_train, monitor_serve
from benchmark.lib import faults
from benchmark.tests import tiny


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_training_fault_is_caught(fault):
    cfg, tr = tiny.train_cell()
    with faults.planted("train", fault):
        out = envdrop_spcl_train.run(tiny.run_of(cfg, tr, 8))
    assert not all(c.ok for c in out.checks), out.checks


@pytest.mark.parametrize("fault", faults.SERVE)
def test_serving_fault_is_caught(fault):
    cfg, tr = tiny.serve_cell()
    with faults.planted("serve", fault):
        out = monitor_serve.run(tiny.run_of(cfg, tr, 9))
    assert not all(c.ok for c in out.checks), out.checks


def test_unknown_fault_raises():
    with pytest.raises(ValueError):
        with faults.planted("serve", "half_batch"):
            pass


def test_a_fault_that_starts_in_the_window_is_caught():
    """Half of the batch left out from the first window iteration on: the
    set-up's checked iterations run sound, the window's checked one not."""
    import torch

    from curriculum_learning_for_vln_torch.engine import loop

    cfg, tr = tiny.train_cell()
    inner, calls = loop.packed_iteration_loss, []
    sound_calls = tr["checked_iterations"] + tr["warmup_iterations"]

    def later(agent, tables, params, ep, pool, generator, w_il=None, w_pool=None, il_len=None):
        calls.append(1)
        if len(calls) > sound_calls:
            half = torch.arange(w_il.shape[0], device=w_il.device) < w_il.shape[0] // 2
            w_il = torch.where(half, 2.0 * w_il, 0.0)
        return inner(agent, tables, params, ep, pool, generator, w_il, w_pool, il_len)

    with faults.patched(loop, "packed_iteration_loss", later):
        out = envdrop_spcl_train.run(tiny.run_of(cfg, tr, 8))
    by = {c.name: c for c in out.checks}
    assert by["first_loss_gap"].ok
    assert not by["window_loss_gap"].ok or not by["window_grad_gap"].ok, out.checks
