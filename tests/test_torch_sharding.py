"""The port's meshes and partition (``launch/mesh.py``,
``sharding/partition.py``) against the reference's: the divisibility
fitting, the paged pool's specs and shardings, the indivisible-heads
fallback, ``make_tp_mesh``, the split of a pool into per-rank shards and its
reassembly; then the training half: every leaf's spec under the QAT and
serving rules for every config, the batch and cache specs, and the blocks
``split_tree`` cuts against JAX's ``devices_indices_map``.

Specs are pure data, so the reference's functions are held against the
port's on the same shapes: on a shape-only mesh, or on JAX's
``AbstractMesh`` where the reference builds ``NamedSharding``s, against a
port ``Mesh`` over ``meta`` devices; the trees are the reference's
``jax.eval_shape`` trees and the port's ``meta`` ones.  A port mesh of
several ranks names the CPU several times.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.configs.base import list_configs
from repro.models import fold as JF
from repro.models import serve_int as JS
from repro.optim import adamw as JA
from repro.sharding import partition as JPt
from repro.train import steps as JSt
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import mesh as M
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.sharding import partition as Pt
from repro_torch.train import steps as St

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


# --- the training half: rules, batch and cache specs, placement ----------------------

MESHES = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
META = torch.device("meta")


def _meshes(name):
    """The reference's abstract mesh and the port's over ``meta`` devices."""
    shape, axes = MESHES[name]
    return (AbstractMesh(shape, axes),
            M.Mesh(np.array([META] * int(np.prod(shape)), dtype=object).reshape(shape), axes))


def _specs(shardings, paths_fn):
    return {p: tuple(s.spec) for p, s in paths_fn(shardings)}


def _hold_specs(jtree, ttree, mode, fsdp, what):
    """Every leaf's spec on the three meshes, the port's against the
    reference's ``make_param_shardings`` (its ``_spec_for`` and
    ``_fit_spec``), path by path."""
    for name in MESHES:
        jmesh, tmesh = _meshes(name)
        want = _specs(JPt.make_param_shardings(jmesh, jtree, mode=mode, fsdp=fsdp),
                      JPt._tree_paths_specs)
        got = _specs(Pt.make_param_shardings(tmesh, ttree, mode=mode, fsdp=fsdp), Pt.tree_paths)
        assert got.keys() == want.keys(), (what, name)
        differ = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
        assert not differ, (what, name, fsdp, differ)


@pytest.mark.parametrize("arch", list_configs())
def test_qat_param_specs_match_reference(arch):
    """The params (the fp32 moments' tree) and the int8 moments (``…/codes``
    and ``…/scale``) of every config at its published size, on data=2
    model=4, 16x16 and 2x16x16, with FSDP on and off."""
    bert = arch == "bert-base"
    jinit = JSt.init_bert_train_state if bert else JSt.init_train_state
    jstate = jax.eval_shape(lambda k: jinit(j_get_config(arch), k, JA.AdamWConfig(
        quantize_moments=True)), jax.random.PRNGKey(0))
    tstate = St.state_shape(get_config(arch), A.AdamWConfig(quantize_moments=True), bert=bert)
    for fsdp in (True, False):
        _hold_specs(jstate.params, tstate.params, "qat", fsdp, f"{arch} params")
        for mom in ("m", "v"):
            _hold_specs(jstate.opt[mom], tstate.opt[mom], "qat", fsdp, f"{arch} int8 {mom}")


@pytest.mark.parametrize("arch", [a for a in list_configs() if a != "bert-base"])
def test_serve_specs_of_the_folded_tree_match_reference(arch):
    """The folded integer tree (smoke size: the rules read paths and ranks)
    under the serving rules on the three meshes."""
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    jst = jax.eval_shape(lambda k: JSt.init_train_state(jcfg, k, JA.AdamWConfig()),
                         jax.random.PRNGKey(0))
    jfolded = jax.eval_shape(lambda p, a: JF.fold_params(jcfg, p, a), jst.params, jst.amax)
    tst = St.state_shape(cfg, A.AdamWConfig())
    tfolded = F.fold_params(cfg, tst.params, tst.amax)
    _hold_specs(jfolded, tfolded, "serve", False, f"{arch} folded")


@pytest.mark.parametrize("arch", ["yi-6b", "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_cache_and_batch_specs_match_reference(arch):
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    jcache = jax.eval_shape(lambda: JS.init_cache(jcfg, 32, 64))
    tcache = S.init_cache(cfg, 32, 64, device=META)
    for name in MESHES:
        jmesh, tmesh = _meshes(name)
        want = _specs(JPt.cache_sharding(jmesh, jcache), JPt._tree_paths_specs)
        got = _specs(Pt.cache_sharding(tmesh, tcache), Pt.tree_paths)
        assert got == want, (arch, name)
        for ndim, shape in ((2, (256, 4096)), (3, (32, 4, 512)), (2, (1, 1)), (2, None)):
            assert tuple(JPt.batch_sharding(jmesh, ndim, shape).spec) == \
                Pt.batch_sharding(tmesh, ndim, shape).spec
        assert Pt.batch_axes(tmesh) == JPt.batch_axes(jmesh)
        assert Pt.replicated(tmesh).spec == tuple(JPt.replicated(jmesh).spec) == ()


_BLOCKS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import smoke_config
from repro.models import serve_int as S
from repro.optim import adamw as A
from repro.sharding import partition as Pt
from repro.train import steps as St
cfg = smoke_config("yi-6b")
state = jax.eval_shape(lambda k: St.init_train_state(cfg, k, A.AdamWConfig(quantize_moments=True)),
                       jax.random.PRNGKey(0))
cache = jax.eval_shape(lambda: S.init_cache(cfg, 4, 16))
devs = np.array(jax.devices())
out = {}
for name, mesh in (("2x2", Mesh(devs[:4].reshape(2, 2), ("data", "model"))),
                   ("2x2x2", Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model")))):
    rank = {d.id: r for r, d in enumerate(mesh.devices.flat)}
    trees = {"params": (state.params, Pt.make_param_shardings(mesh, state.params)),
             "m": (state.opt["m"], Pt.make_param_shardings(mesh, state.opt["m"])),
             "cache": (cache, Pt.cache_sharding(mesh, cache))}
    for what, (tree, shs) in trees.items():
        for (p, v), (_, s) in zip(Pt._tree_paths_specs(tree), Pt._tree_paths_specs(shs)):
            idx = s.devices_indices_map(v.shape)
            out[f"{name}:{what}:{p}"] = [
                [[sl.start or 0, v.shape[i] if sl.stop is None else sl.stop]
                 for i, sl in enumerate(idx[d])] for d in sorted(idx, key=lambda d: rank[d.id])]
    bs = Pt.batch_sharding(mesh, 2, (4, 16))
    idx = bs.devices_indices_map((4, 16))
    out[f"{name}:batch"] = [[[sl.start or 0, (4, 16)[i] if sl.stop is None else sl.stop]
                             for i, sl in enumerate(idx[d])]
                            for d in sorted(idx, key=lambda d: rank[d.id])]
json.dump(out, sys.stdout)
"""


def test_split_tree_blocks_equal_jax_devices_indices_map():
    """On (2, 2) and (2, 2, 2) meshes, each rank's block of every leaf of
    the smoke state (params, int8 first moments), of the decode cache and of
    a batch is the slice JAX's ``NamedSharding.devices_indices_map`` gives
    the device at the same mesh position (row-major), and ``split_tree``
    cuts exactly those slices."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    want = json.loads(subprocess.run([sys.executable, "-c", _BLOCKS], env=env, check=True,
                                     capture_output=True, text=True).stdout)
    cfg = smoke_config("yi-6b")
    opt = A.AdamWConfig(quantize_moments=True)
    state = St.init_train_state(cfg, torch.Generator().manual_seed(0), opt)
    state = dataclasses.replace(state, opt=dict(state.opt, m=T.tree_map(
        lambda q: A._q(torch.randn(q.codes.shape)), state.opt["m"])))
    cache = S.init_cache(cfg, 4, 16, device="cpu")
    batch = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    n = 0
    for name in ("2x2", "2x2x2"):
        shape, axes = ((2, 2), ("data", "model")) if name == "2x2" else \
            ((2, 2, 2), ("pod", "data", "model"))
        mesh = M.Mesh(np.array([CPU] * int(np.prod(shape)), dtype=object).reshape(shape), axes)
        for what, tree, shs in (
                ("params", state.params, Pt.make_param_shardings(mesh, state.params)),
                ("m", state.opt["m"], Pt.make_param_shardings(mesh, state.opt["m"])),
                ("cache", cache, Pt.cache_sharding(mesh, cache)),
                ("batch", {"t": batch}, {"t": Pt.batch_sharding(mesh, 2, (4, 16))})):
            shards = Pt.split_tree(tree, shs)
            for p, v in Pt.tree_paths(tree, sort_keys=True):
                key = f"{name}:{what}:{p}" if what != "batch" else f"{name}:batch"
                sl = [tuple(slice(a, b) for a, b in dims) for dims in want[key]]
                for r, s in enumerate(shards):
                    blk = dict(Pt.tree_paths(s, sort_keys=True))[p]
                    assert torch.equal(blk, v[sl[r]]), (key, r)
                    assert blk.is_contiguous()
                n += 1
    assert n == 2 * (len(Pt.tree_paths(state.params)) + len(Pt.tree_paths(state.opt["m"]))
                     + len(Pt.tree_paths(cache)) + 1)
