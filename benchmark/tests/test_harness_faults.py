"""The comparison that decides `correct`, shown to fail: with the timed
path broken underneath (the harness's own look for a card skipped), a
rehearsal of each cell comes out not correct. The faults: a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest; an answer altered where it is produced (for planning, the
chosen push and, apart, the population's rewards). (The exchange
between chips does not exist in these one-card cells.)"""

from __future__ import annotations

import pytest
import torch


def _frozen_model(monkeypatch):
    """The model's step returns the last state: no motion."""
    from adaptigraph_torch.dynamics import model as m
    forward = m.DynamicsPredictor.forward

    def still(self, state, attrs, recv, send, edge_valid, p_instance, *a,
              **k):
        pred, motion = forward(self, state, attrs, recv, send, edge_valid,
                               p_instance, *a, **k)
        n_obj = p_instance.shape[1]
        return state[:, -1, :n_obj].float(), torch.zeros_like(motion)
    monkeypatch.setattr(m.DynamicsPredictor, "forward", still)


def _half_batch_model(monkeypatch):
    """The model computes the first half of each batch; the rest of its
    rows keep their last state."""
    from adaptigraph_torch.dynamics import model as m
    forward = m.DynamicsPredictor.forward

    def half(self, state, attrs, recv, send, edge_valid, p_instance, *a,
             **k):
        pred, motion = forward(self, state, attrs, recv, send, edge_valid,
                               p_instance, *a, **k)
        h = state.shape[0] // 2
        n_obj = p_instance.shape[1]
        pred = torch.cat([pred[:h], state[h:, -1, :n_obj].float()])
        return pred, motion
    monkeypatch.setattr(m.DynamicsPredictor, "forward", half)


def _altered_answer(monkeypatch):
    """The planner's chosen push moved by 1e-3 where it is returned."""
    from adaptigraph_torch.planning import planner as p
    optimize = p.Planner.trajectory_optimization

    def altered(self, *a, **k):
        res = optimize(self, *a, **k)
        res["act_seq"] = res["act_seq"] + 1e-3
        return res
    monkeypatch.setattr(p.Planner, "trajectory_optimization", altered)


def _altered_reward(monkeypatch):
    """The population's rewards scaled by 1.001 where they are produced."""
    from adaptigraph_torch.planning import costs as c
    assemble = c.assemble_reward

    def scaled(parts):
        out = assemble(parts)
        return dict(out, reward_seqs=out["reward_seqs"] * 1.001)
    monkeypatch.setattr(c, "assemble_reward", scaled)


def _state_unchanged(monkeypatch):
    """Adam's update does nothing: the parameters and its moments stay."""
    import importlib
    adam = importlib.import_module("torch.optim.adam")
    monkeypatch.setattr(adam, "adam", lambda *a, **k: None)


def _half_batch_loss(monkeypatch):
    """The loss over the first half of each batch alone."""
    from adaptigraph_torch.dynamics import train as t
    make = t.make_unrolled_loss

    def half(model, n_future):
        loss = make(model, n_future)

        def fn(params, batch):
            b = batch["state"].shape[0]
            return loss(params, {k: v[:b // 2] for k, v in batch.items()})
        return fn
    monkeypatch.setattr(t, "make_unrolled_loss", half)


def _altered_loss(monkeypatch):
    """The loss scaled by 1.001 where it is produced."""
    from adaptigraph_torch.dynamics import train as t
    make = t.make_unrolled_loss

    def scaled(model, n_future):
        loss = make(model, n_future)
        return lambda params, batch: loss(params, batch) * 1.001
    monkeypatch.setattr(t, "make_unrolled_loss", scaled)


MPPI = {"state unchanged": _frozen_model, "half batch": _half_batch_model,
        "answer altered": _altered_answer, "reward altered": _altered_reward}
TRAIN = {"state unchanged": _state_unchanged, "half batch": _half_batch_loss,
         "answer altered": _altered_loss}
CASES = ([("rope.mppi", k) for k in MPPI]
         + [("granular.mppi", k) for k in MPPI]
         + [("rope.train", k) for k in TRAIN])


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(rehearse, monkeypatch, workload, fault):
    plant = (TRAIN if workload.endswith("train") else MPPI)[fault]
    plant(monkeypatch)
    out = rehearse(workload)
    assert out["correct"] is False, out["checks"]
