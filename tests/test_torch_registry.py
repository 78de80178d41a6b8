"""The port's model registry against the reference: the ten architecture
ids in the reference's order, ``all_configs`` field for field (full and
smoke), ``shape_applicable`` over the 40 (arch x shape) cells
(tests/test_models.py's count: ``long_500k`` skipped for the 8 archs
without sub-quadratic sequence mixing), and each config's ``init_params``
layout on its smoke config against the reference's.  Exact equality
throughout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.models import model as ref_model
from repro_torch.configs import base
from repro_torch.configs import registry
from repro_torch.models import model


def test_arch_ids_are_the_references_ten_in_order():
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert len(registry.ARCH_IDS) == 10


def test_all_configs_equal_the_references_field_by_field():
    got, want = registry.all_configs(), ref_registry.all_configs()
    assert list(got) == list(want)
    for arch in want:
        assert dataclasses.asdict(got[arch]) == dataclasses.asdict(want[arch]), arch
        assert dataclasses.asdict(registry.get_smoke_config(arch)) == \
            dataclasses.asdict(ref_registry.get_smoke_config(arch)), arch


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_shape_applicable_equals_the_reference_on_every_shape(arch):
    assert list(base.SHAPES) == list(ref_base.SHAPES)
    for name in ref_base.SHAPES:
        assert base.shape_applicable(registry.get_config(arch), base.SHAPES[name]) == \
            ref_base.shape_applicable(ref_registry.get_config(arch), ref_base.SHAPES[name])


def test_shape_applicability_covers_40_cells():
    cells = [(a, s) for a in registry.ARCH_IDS for s in base.SHAPES]
    assert len(cells) == 40
    skips = [c for c in cells
             if not base.shape_applicable(registry.get_config(c[0]), base.SHAPES[c[1]])[0]]
    assert len(skips) == 8 and all(s == "long_500k" for _, s in skips)


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return tuple(np.shape(tree)), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_every_arch_inits_the_reference_layout_on_its_smoke_config(arch):
    cfg = registry.get_smoke_config(arch)
    want = jax.eval_shape(lambda: ref_model.init_params(jax.random.PRNGKey(0), cfg))
    assert _layout(model.init_params(0, cfg, device="cpu")) == _layout(want)
