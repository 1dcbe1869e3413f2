"""Port parity: the config reader (utils/config.py), the port's copies of
the nine YAML configs and model_config_from_yaml, against PyYAML and the
JAX package.

All exact: the reader gives what yaml.safe_load gives, values and types;
the copies equal the JAX files byte for byte; the ModelConfig fields equal
JAX's (the compute dtype by name), with and without the
ADAPTIGRAPH_GNN_AGG / ADAPTIGRAPH_GNN_DTYPE overrides.
"""

import math
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
import yaml

from adaptigraph_tpu.dynamics.model import model_config_from_yaml as j_mcfg
from adaptigraph_tpu.utils import config as jconfig
from adaptigraph_torch.dynamics.model import model_config_from_yaml as t_mcfg
from adaptigraph_torch.utils import config as tconfig

_ROOT = Path(__file__).resolve().parents[1]
_NAMES = sorted(str(p.relative_to(_ROOT / "adaptigraph_tpu" / "configs"))
                for p in (_ROOT / "adaptigraph_tpu" / "configs").glob("*/*.yaml"))


def _same(a, b):
    """Equal values of the same types, at every depth (and key order)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_nine_configs():
    assert len(_NAMES) == 9


@pytest.mark.parametrize("name", _NAMES)
def test_reader_equals_safe_load(name):
    text = (_ROOT / "adaptigraph_tpu" / "configs" / name).read_text()
    assert _same(tconfig.parse_yaml(text), yaml.safe_load(text))
    loaded = tconfig.load_config(name[:-len(".yaml")])
    assert _same(loaded.to_dict(), jconfig.load_config(name).to_dict())


@pytest.mark.parametrize("name", _NAMES)
def test_port_copies_are_byte_identical(name):
    ours = (_ROOT / "adaptigraph_torch" / "configs" / name).read_bytes()
    assert ours == (_ROOT / "adaptigraph_tpu" / "configs" / name).read_bytes()


@pytest.mark.parametrize("text", [
    "a: 1\nb:\nc: ~\nd: null\n",
    "a: '1'\nb: \"x\\ty\"\nc: 1e5\nd: 1.5e+3\ne: 0.\nf: -.5\ng: -.inf\n",
    "a: yes\nb: Off\nc: TRUE\nd: 1_000\ne: +7\nf: -0\n",
    "x:\n- a: 1\n  b: [1, 2, {c: d, 'e': \"f\"}]\n- - 1\n  - 2\n-\n  - 3\n",
    "k: 'it''s'  # a comment\nm: a#b\nn: [ ]\no: {}\np: dump/t.npy\n",
    "# leading comment\nouter:\n  inner:\n    - {name: \"s\", use: true, min: 0., max: 1.}\n  after: 2\n",
    "- 1\n- 2\n",
    "plain words",
])
def test_reader_equals_safe_load_on_the_subset(text):
    assert _same(tconfig.parse_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n", "---\na: 1\n",
    "a: 0x10\n", "a: 017\n", "a: [1, 2\n", "a: 1\n  b: 2\n",
])
def test_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        tconfig.parse_yaml(text)


def test_config_behaves_as_jax():
    data = {"a": {"b": 1, "c": [{"d": 2}]}, "e": 3}
    j, t = jconfig.Config(data), tconfig.Config(data)
    assert t.a.b == j.a.b == 1 and t.a.c[0].d == j.a.c[0].d == 2
    over = {"a": {"b": 5, "x": {"y": 1}}}
    assert _same(t.override(over, e=4).to_dict(),
                 j.override(over, e=4).to_dict())
    assert t.a.b == 1  # override returns a copy
    t.f = {"g": 1}
    assert t.f.g == 1
    with pytest.raises(AttributeError):
        t.missing


@pytest.mark.parametrize("material", ["rope", "granular", "cloth"])
@pytest.mark.parametrize("env", [{}, {"ADAPTIGRAPH_GNN_AGG": "slotted",
                                      "ADAPTIGRAPH_GNN_DTYPE": "bf16"}])
def test_model_config_from_yaml_equals_jax(material, env, monkeypatch):
    for k in ("ADAPTIGRAPH_GNN_AGG", "ADAPTIGRAPH_GNN_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jc = jconfig.load_config(f"dynamics/{material}")
    tc = tconfig.load_config(f"dynamics/{material}")
    jm = j_mcfg(jc["model_config"], jc["dataset_config"], 1)
    tm = t_mcfg(tc["model_config"], tc["dataset_config"], 1)
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for field in tm.__dataclass_fields__:
        jv, tv = getattr(jm, field), getattr(tm, field)
        if field == "compute_dtype":
            assert dtypes[jv] is tv
        else:
            assert type(jv) is type(tv) and jv == tv, field
    assert tm.aggregation == env.get("ADAPTIGRAPH_GNN_AGG", "matmul")
    assert (tm.particle_in, tm.relation_in) == (6, 17)
