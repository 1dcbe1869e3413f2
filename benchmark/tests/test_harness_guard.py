"""The import and environment guard."""

from __future__ import annotations

import types

import pytest

import run as runner
from harness import guard


def test_refused_modules_compare_top_level_names_whole():
    mods = {"adaptigraph_tpu.x": None, "adaptigraph_torch": None,
            "adaptigraph_torch.dynamics": None, "jaxlib.xla": None,
            "jaxtyping": None, "numpy": None}
    assert guard.refused_modules(mods) == ["adaptigraph_tpu.x", "jaxlib.xla"]


def test_a_fake_jax_package_module_is_caught(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "adaptigraph_tpu.x",
                        types.ModuleType("adaptigraph_tpu.x"))
    assert "adaptigraph_tpu.x" in guard.refused_modules()


def test_refused_environment():
    assert guard.refused_env({"ADAPTIGRAPH_GNN_AGG": "segment"}) == [
        "ADAPTIGRAPH_GNN_AGG"]
    assert guard.refused_env({"ADAPTIGRAPH_GNN_DTYPE": "bf16", "X": "1"}) == [
        "ADAPTIGRAPH_GNN_DTYPE"]
    assert guard.refused_env({}) == []


@pytest.mark.parametrize("var", guard.REFUSED_ENV)
def test_a_run_refuses_to_start(monkeypatch, capsys, var):
    monkeypatch.setenv(var, "x")
    assert runner.main(["--workload", "rope.mppi", "--seed", "1",
                        "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_measuring_run_without_a_card_fails(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert runner.main(["--workload", "rope.train", "--seed", "1",
                        "--seconds", "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


def test_cache_dirs_are_fixed_and_inside(tmp_path, monkeypatch):
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.delenv(k, raising=False)
    dirs = guard.set_cache_dirs(str(tmp_path))
    assert dirs == guard.set_cache_dirs(str(tmp_path))
    assert all(v.startswith(str(tmp_path)) for v in dirs.values())
