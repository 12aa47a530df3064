"""nmftpu_torch.config and nmftpu_torch.convert against nmftpu.config: the
same fields, defaults, enums and validation, so one configuration drives
both packages."""

import dataclasses
import enum

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmftpu  # noqa: E402
import nmftpu_torch  # noqa: E402
from nmftpu import config as jcfg  # noqa: E402
from nmftpu_torch import config as tcfg  # noqa: E402
from nmftpu_torch.convert import config_from_nmftpu  # noqa: E402


def _plain(v):
    return v.value if isinstance(v, enum.Enum) else v


def test_field_names_and_defaults_match():
    jf = [(f.name, _plain(f.default)) for f in
          dataclasses.fields(nmftpu.NmfConfig)]
    tf = [(f.name, _plain(f.default)) for f in
          dataclasses.fields(nmftpu_torch.NmfConfig)]
    assert tf == jf


@pytest.mark.parametrize("name", ["Algorithm", "Objective", "Initialization",
                                  "ThresholdType", "MatrixFormat"])
def test_enums_match(name):
    j = {m.name: m.value for m in getattr(jcfg, name)}
    t = {m.name: m.value for m in getattr(tcfg, name)}
    assert t == j


# each case: keyword arguments to both NmfConfigs
CASES = [
    {},
    {"objective": "kullback-leibler"},
    {"objective": "itakura-saito"},
    {"objective": "beta-divergence", "beta": 2.0},
    {"objective": "beta-divergence", "beta": 1.0},
    {"objective": "beta-divergence", "beta": 0.5},
    {"objective": "beta-divergence"},
    {"beta": 0.5},
    {"dtype": "double"},
    {"dtype": np.float64},
    {"dtype": "float64", "use_pallas": True},
    {"use_pallas": True, "v_storage": "int8"},
    {"v_storage": "float16"},
    {"update_order": "WW"},
    {"mu_style": "jacobi"},
    {"mu_style": "jacobi", "use_pallas": True},
    {"mu_style": "jacobi", "use_pallas": True, "v_storage": "int8"},
    {"algorithm": "als", "mu_style": "jacobi"},
    {"algorithm": "hals", "v_storage": "int8"},
    {"algorithm": "als", "objective": "kullback-leibler"},
    {"alpha_confidence": 1.0, "algorithm": "hals"},
    {"mask": "observed", "v_storage": "int8"},
    {"als_solver": "cg"},
    {"l1_w": 0.1},
    {"theta": 1.5},
    {"alpha_h": -0.1},
    {"rank": 0},
    {"num_iterations": -1},
    {"num_runs": 0},
    {"check_interval": 0},
    {"cg_steps": 0},
]


@pytest.mark.parametrize("kwargs", CASES, ids=[str(c) for c in CASES])
def test_validation_and_canonical_form_match(kwargs):
    kwargs = {"rank": 4, **kwargs}

    def build(mod):
        try:
            cfg = mod.NmfConfig(**kwargs)
        except ValueError:
            return "ValueError"
        return {f.name: _plain(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}

    assert build(tcfg) == build(jcfg)


@pytest.mark.parametrize("alias,name", [
    ("float32", "float32"), ("f8", "float64"), ("double", "float64"),
    (np.float64, "float64"), (torch.float64, "float64"),
    (torch.bfloat16, "bfloat16"), ("bfloat16", "bfloat16"),
])
def test_dtype_canonicalization(alias, name):
    assert tcfg.NmfConfig(rank=2, dtype=alias).dtype == name


def test_resolve_dtype_returns_torch_dtypes():
    assert tcfg.resolve_dtype("float32") is torch.float32
    assert tcfg.resolve_dtype("float64") is torch.float64
    assert tcfg.resolve_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        tcfg.resolve_dtype("int32")


def test_enum_strings_coerced():
    cfg = tcfg.NmfConfig(rank=3, objective="kullback-leibler",
                         init_method="copy_existing")
    assert cfg.objective is tcfg.Objective.KL
    assert cfg.init_method is tcfg.Initialization.COPY_EXISTING


def test_config_from_nmftpu_carries_every_field():
    j = nmftpu.NmfConfig(
        rank=7, objective="beta-divergence", beta=0.5, seed=3,
        num_iterations=17, threshold_value=1e-3, threshold_type="rmsd",
        check_interval=4, v_storage="bfloat16", update_order="HW",
        verbosity=2,
    )
    t = config_from_nmftpu(j)
    assert isinstance(t, tcfg.NmfConfig)
    for f in dataclasses.fields(j):
        assert _plain(getattr(t, f.name)) == _plain(getattr(j, f.name)), f
