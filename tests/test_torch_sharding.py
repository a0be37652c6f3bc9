"""The port's tensor-parallel mesh and the paged pool's partition
(``launch/mesh.py``, ``sharding/partition.py``) against the reference's
``tests/test_sharding.py``: the divisibility fitting, the pool specs and
shardings, the indivisible-heads fallback and ``make_tp_mesh``; then the
split of a pool into per-rank shards and its reassembly.

Specs are pure data, so the reference's ``_fit_spec`` and pool specs are
held against the port's on the same shapes and a shape-only mesh.  A port
mesh of several ranks names the CPU several times.
"""
import types

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.sharding import partition as JPt
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as M
from repro_torch.models import serve_int as S
from repro_torch.sharding import partition as Pt

CPU = torch.device("cpu")


def _fake_mesh(**axes):
    return types.SimpleNamespace(shape=dict(axes), axis_names=tuple(axes))


@pytest.mark.parametrize("spec,shape,axes,want", [
    ((None, "model", None), (3, 8, 5), dict(data=2, model=4), (None, "model", None)),
    (("data", "model"), (4, 6), dict(data=2, model=4), ("data", None)),       # 6 % 4 != 0
    ((None, "model", None), (4, 4), dict(model=2), (None, "model")),          # trimmed to rank
    ((("data", "model"), None), (8, 3), dict(data=2, model=4), (("data", "model"), None)),
    ((("data", "model"), None), (6, 3), dict(data=2, model=4), ("data", None)),
])
def test_fit_spec_matches_reference(spec, shape, axes, want):
    mesh = _fake_mesh(**axes)
    got = Pt._fit_spec(spec, shape, mesh)
    assert got == want
    assert got == tuple(JPt._fit_spec(JP(*spec), shape, mesh))


def test_kv_pool_pspec_shards_only_heads():
    sp = Pt.kv_pool_pspec()
    # (n_reps, n_pages, P, Hkv, hd): the page axis stays whole, so page ids
    # are global and one host allocator addresses every rank
    assert sp == (None, None, None, "model", None)
    assert sp == tuple(JPt.kv_pool_pspec())


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_pool_shardings_and_specs_match_reference(kv_bits):
    cfg = smoke_config("yi-6b")                      # nkv = 4
    mesh = M.TPMesh((CPU,) * 2)
    pool = S.init_paged_cache(cfg, 9, 4, kv_bits, device="cpu")
    sh = Pt.paged_pool_shardings(mesh, pool)
    specs = Pt.kv_pool_specs(pool, mesh)
    fake = _fake_mesh(model=2)
    for slot, leaves in pool.items():
        for name, v in leaves.items():
            assert sh[slot][name].mesh is mesh
            want = tuple(JPt._fit_spec(JPt.kv_pool_pspec(), tuple(v.shape), fake))
            assert sh[slot][name].spec == want
            # kv_pool_specs: payload split over Hkv, kv4's 2-D scales replicated
            assert specs[slot][name] == (want if v.dim() == 5 else (None, None))
    assert (kv_bits == 4) == ("ks" in pool["slot0"])


def test_paged_pool_shardings_drops_indivisible_heads():
    # Hkv=3 on a 4-way model axis cannot split: fitted to unsplit (the
    # engine refuses such a mesh before it builds a pool), and split_pool
    # refuses to cut it
    mesh = _fake_mesh(model=4)
    assert Pt._fit_spec(Pt.kv_pool_pspec(), (2, 9, 4, 3, 32), mesh) == (None,) * 5
    pool = {"slot0": {"k": torch.zeros((2, 9, 4, 3, 32), dtype=torch.int8)}}
    with pytest.raises(ValueError, match="does not divide"):
        Pt.split_pool(pool, M.TPMesh((CPU,) * 4))


def test_make_tp_mesh_shape_and_axis():
    mesh = M.make_tp_mesh(1, "cpu")
    assert mesh.axis_names == ("model",) and mesh.shape["model"] == 1 and mesh.size == 1
    assert mesh.devices == (CPU,)
    explicit = M.TPMesh(("cpu",) * 4)
    assert explicit.shape["model"] == 4 and explicit.devices == (CPU,) * 4
    assert M.TPMesh(("cuda",)).devices == (torch.device("cuda", 0),)


def test_make_tp_mesh_rejects_oversubscription():
    with pytest.raises(ValueError, match="needs 2 cpu devices, found 1"):
        M.make_tp_mesh(2, "cpu")
    with pytest.raises(ValueError, match="at least one device"):
        M.TPMesh(())


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_split_then_gather_is_the_identity(kv_bits, tp):
    """Each shard is a contiguous (n_reps, n_pages, P, Hkv/tp, hd) tensor
    with rank r's block of heads of every page (kv4's scales copied whole),
    laid out as ``init_paged_cache(mesh=)`` lays out a fresh pool, and the
    reassembly gives the pool back bit for bit."""
    cfg = smoke_config("yi-6b")
    mesh = M.TPMesh((CPU,) * tp)
    rng = np.random.default_rng(kv_bits + tp)
    pool = S.init_paged_cache(cfg, 9, 4, kv_bits, device="cpu")
    for leaves in pool.values():
        for name, v in leaves.items():
            fill = rng.normal(size=v.shape) if v.is_floating_point() else \
                rng.integers(0, 256, v.shape) - (0 if v.dtype == torch.uint8 else 128)
            v.copy_(torch.as_tensor(fill).to(v.dtype))
    shards = Pt.split_pool(pool, mesh)
    fresh = S.init_paged_cache(cfg, 9, 4, kv_bits, mesh=mesh)
    assert len(shards) == len(fresh) == tp
    h = cfg.n_kv_heads // tp
    for r, (shard, empty) in enumerate(zip(shards, fresh)):
        for slot, leaves in pool.items():
            for name, v in leaves.items():
                got = shard[slot][name]
                assert got.is_contiguous() and got.device == CPU
                assert got.shape == empty[slot][name].shape
                assert got.data_ptr() != v.data_ptr()
                if v.dim() == 5:
                    assert got.shape == (*v.shape[:3], h, v.shape[4])
                    assert torch.equal(got, v[:, :, :, r * h:(r + 1) * h])
                else:
                    assert torch.equal(got, v)
    back = Pt.gather_pool(shards, mesh)
    for slot, leaves in pool.items():
        for name, v in leaves.items():
            assert torch.equal(back[slot][name], v)
    with pytest.raises(ValueError, match="shards for a"):
        Pt.gather_pool(shards[:-1] if tp > 1 else shards * 2, mesh)
