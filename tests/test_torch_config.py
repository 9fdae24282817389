"""The port's config equals the JAX package's: every constant and every
dataclass default."""

import dataclasses

import pytest

import mcptam_tpu.config as ref
import mcptam_tpu_torch.config as port

CONSTANTS = sorted(n for n in dir(ref) if n.isupper() and not n.startswith("DEFAULT_"))
CLASSES = ["TrackerConfig", "FeatureConfig", "MapMakerConfig", "BundleConfig"]
DEFAULTS = ["DEFAULT_TRACKER", "DEFAULT_FEATURES", "DEFAULT_MAPMAKER",
            "DEFAULT_BUNDLE"]


def test_same_public_names():
    names = {n for n in dir(ref) if not n.startswith("_")}
    assert names - {"dataclasses", "annotations"} <= set(dir(port))


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_equal(name):
    assert getattr(port, name) == getattr(ref, name)


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_defaults_equal(name):
    r, p = getattr(ref, name), getattr(port, name)
    assert [f.name for f in dataclasses.fields(p)] == [
        f.name for f in dataclasses.fields(r)]
    assert dataclasses.asdict(p()) == dataclasses.asdict(r())
    assert p.__dataclass_params__.frozen == r.__dataclass_params__.frozen


@pytest.mark.parametrize("name", DEFAULTS)
def test_default_instances_equal(name):
    assert dataclasses.asdict(getattr(port, name)) == dataclasses.asdict(
        getattr(ref, name))
