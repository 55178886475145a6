"""The port's copies of `geovpr.core.config` and `geovpr.cli.presets`
(`geovpr_torch/core/config.py`, `geovpr_torch/cli/presets.py`) against the
originals, field for field."""

import dataclasses

import pytest

import geovpr.cli.presets as jpresets
import geovpr.core.config as jconfig
import geovpr_torch.cli.presets as tpresets
import geovpr_torch.core.config as tconfig

_CLASSES = ("DataConfig", "ModelConfig", "OptimConfig", "TrainConfig",
            "GeoposeConfig", "AngleConfig", "RetrievalConfig")


def _fields(cls):
    return [(f.name, str(f.type), f.default,
             f.default_factory() if f.default_factory is not dataclasses.MISSING
             else dataclasses.MISSING) for f in dataclasses.fields(cls)]


def _as_tree(cfg):
    """A config as nested (class name, {field: value}) pairs."""
    if dataclasses.is_dataclass(cfg):
        return (type(cfg).__name__, {f.name: _as_tree(getattr(cfg, f.name))
                                     for f in dataclasses.fields(cfg)})
    return cfg


@pytest.mark.parametrize("name", _CLASSES)
def test_dataclasses_match_field_for_field(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert dataclasses.is_dataclass(t)
    assert t.__dataclass_params__.frozen == j.__dataclass_params__.frozen
    assert [(n, ty) for n, ty, *_ in _fields(t)] == \
        [(n, ty) for n, ty, *_ in _fields(j)]
    assert _as_tree(t()) == _as_tree(j())


def test_no_other_dataclass_on_either_side():
    def classes(mod):
        return {n for n, v in vars(mod).items()
                if dataclasses.is_dataclass(v) and isinstance(v, type)}
    assert classes(tconfig) == classes(jconfig) == set(_CLASSES)


@pytest.mark.parametrize("table", ["GEOPOSE_PRESETS", "ANGLE_PRESETS",
                                   "RETRIEVAL_PRESETS"])
def test_presets_match(table):
    j, t = getattr(jpresets, table), getattr(tpresets, table)
    assert list(t) == list(j)
    for name in j:
        assert _as_tree(tpresets.build_preset(name)) == \
            _as_tree(jpresets.build_preset(name)), name


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown preset"):
        tpresets.build_preset("nope")
