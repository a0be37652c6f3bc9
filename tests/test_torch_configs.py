"""The port's config registry equals the reference's, field by field, for
every registered arch and for the smoke reduction of each."""
import dataclasses

import pytest
import torch

import repro.configs as jc
import repro_torch.configs as tc

ARCHS = sorted(jc.list_configs())


def test_registries_match():
    assert sorted(tc.list_configs()) == ARCHS


def _assert_same(a, b):
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa.keys() == fb.keys()
    for k in fa:
        if k == "quant":
            assert dataclasses.asdict(fa[k]) == dataclasses.asdict(fb[k]), k
        else:
            assert fa[k] == fb[k], (a.name, k, fa[k], fb[k])
    assert (a.hd, a.pattern, a.n_params_estimate) == (b.hd, b.pattern, b.n_params_estimate)
    want = torch.bfloat16 if a.param_dtype == "bfloat16" else torch.float32
    assert b.dtype == want


@pytest.mark.parametrize("arch", ARCHS)
def test_config_field_by_field(arch):
    _assert_same(jc.get_config(arch), tc.get_config(arch))
    _assert_same(jc.smoke_config(arch), tc.smoke_config(arch))
