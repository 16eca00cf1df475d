"""The port's distribution layer (``repro_torch.dist``, ``launch.mesh``)
against the JAX package's, exactly.

- Resolution: for every logical name in ``DEFAULT_RULES``, ``None``, an
  unknown name, duplicates, non-dividing shapes and the multi-axis batch
  rule, the port's ``spec`` and ``axis_size`` equal the reference's
  ``DistContext`` on ("data", "model") meshes of (1, 1), (4, 1), (2, 2)
  and (16, 16) and the ("pod", "data", "model") mesh of (2, 16, 16). Both
  read only the mesh's axis names and sizes, so stand-ins do for meshes
  this host cannot make.
- ``sharding``: the DTensor placements mean the reference's spec
  (``Shard(i)`` on each mesh axis of dim i's entry), per leaf through
  ``param_sharding``, a "model" axis wider than 1 included; under such an
  axis a family outside ``FAMILIES`` raises ``NotImplementedError``
  naming it, and a model built outside the mesh raises when it runs
  under it (the tensor-parallel runs themselves:
  ``tests/test_torch_tp*.py``).
- Context management, ``constraint`` and ``gather_fsdp`` without a
  context: the reference's ``tests/test_dist*.py`` cases.
- ``Model.param_axes()`` equals the reference's with its layer axis
  stripped (reduced qwen3-4b, phi3-mini, rwkv6-7b).
- ``Topology.from_dist`` and ``TieredCheckpointManager(dp_size=None)``
  under a context give the reference's answers.
- Decode under a one-rank CPU mesh (a gloo group in this process) gives
  the logits it gives without one: the port of
  ``test_decode_matches_unsharded``, with qwen3-4b where the reference
  takes glm4-9b (the port builds glm4-9b at full width in
  ``tests/test_torch_dryrun.py``).
- Two ``Trainer`` steps under that mesh (the ZeRO-3 step: DTensor masters,
  the gather, the gradient reduction, the clip's all-reduce) give the
  loss, master weights and moments of the same steps without it, bit for
  bit: bfloat16 qwen3-4b and rwkv6-7b, remat "full", and float32 with
  gradient accumulation (``chip_smoke.py`` phase 14 holds the same on the
  card at full width).
- After such steps the model's working weights hold no storage: serving
  and ``master_params`` raise until ``load_working`` brings the masters
  back, after which prefill gives the unsharded model's logits exactly;
  the step's gradient hooks go with the trainer.
"""
import dataclasses
import gc
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.diagnose.whatif import Topology as JaxTopology
from repro.dist import api as jax_dist
from repro.models.model import Model as JaxModel
from repro.train.checkpoint import \
    TieredCheckpointManager as JaxTieredCheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params
from repro_torch.diagnose.whatif import Topology
from repro_torch.dist import api as dist
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.common import Policy
from repro_torch.models.model import Model
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                               TieredCheckpointManager, TrainConfig, Trainer)
from repro_torch.train.trainer import load_working, master_params


def fake_mesh(**shape):
    """What both packages' resolution reads of a mesh: its axis names and
    their sizes."""
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


MESHES = [dict(data=1, model=1), dict(data=4, model=1),
          dict(data=2, model=2), dict(data=16, model=16),
          dict(pod=2, data=16, model=16)]
NAMES = sorted(dist.DEFAULT_RULES) + [None, "not_a_rule"]
SHAPES = [None, (1,), (2,), (12,), (16,), (32,), (48,), (512,)]


def _pair(shape):
    mesh = fake_mesh(**shape)
    return dist.DistContext(mesh), jax_dist.DistContext(mesh)


def test_rule_tables_are_equal():
    assert dist.DEFAULT_RULES == jax_dist.DEFAULT_RULES


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_resolution_matches_reference(shape):
    ours, ref = _pair(shape)
    for name in NAMES:
        assert ours.mesh_axes(name) == ref.mesh_axes(name), name
        assert ours.axis_size(name) == ref.axis_size(name), name
        for dim in SHAPES:
            want = tuple(ref.spec((name,), dim))
            assert ours.spec((name,), dim) == want, (name, dim)
    # two and three dims: duplicate suppression (both orders), the
    # fallback freeing an axis for a later dim, the multi-axis batch rule
    for axes in [("fsdp", "tp"), ("tp", "ff"), ("heads", "ff"),
                 ("act_batch", None, "act_heads", None),
                 ("act_batch", "fsdp"), ("fsdp", "act_batch"),
                 ("vocab", "fsdp"), ("fsdp", "vocab"), (None, None, "fsdp"),
                 ("heads", "kv_heads", "fsdp"), ("not_a_rule", "tp")]:
        for dims in [None, (12, 32, 64, 128)[:len(axes)],
                     (32, 12, 16, 8)[:len(axes)], (16, 8, 48, 2)[:len(axes)]]:
            want = tuple(ref.spec(axes, dims))
            assert ours.spec(axes, dims) == want, (axes, dims)


def test_resolution_rank_mismatch_raises_as_the_reference():
    ours, ref = _pair(dict(data=4, model=1))
    with pytest.raises(ValueError):
        ref.spec(("fsdp", "tp"), (8,))
    with pytest.raises(ValueError):
        ours.spec(("fsdp", "tp"), (8,))


def test_reference_edge_cases_resolve_the_same():
    """``tests/test_dist_edge.py``'s divisibility cases."""
    ctx = dist.DistContext(fake_mesh(data=2, model=16))
    assert ctx.spec(("heads", None), shape=(12, 64)) == (None, None)
    assert ctx.spec(("heads", None), shape=(32, 64)) == ("model", None)
    assert ctx.spec(("heads", "ff"), shape=(12, 32)) == (None, "model")
    ctx = dist.DistContext(fake_mesh(pod=2, data=16, model=16))
    assert ctx.spec(("act_batch", None), shape=(32, 8)) == \
        (("pod", "data"), None)
    assert ctx.spec(("act_batch", None), shape=(16, 8)) == (None, None)
    assert ctx.axis_size("act_batch") == 32
    assert ctx.mesh_axes("layer") == ()
    ctx = dist.DistContext(fake_mesh(data=4, model=2))
    assert ctx.spec(("act_batch",), shape=(8,)) == ("data",)
    assert ctx.spec(("not_a_rule", "tp")) == (None, "model")


def _placements_of(spec, names):
    """The DTensor placements a reference spec means on a mesh of
    ``names``: Shard(i) on every mesh axis of dim i's entry."""
    dim_of = {}
    for i, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else entry or ():
            dim_of[axis] = i
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]


@pytest.mark.parametrize("shape", [dict(data=1, model=1),
                                   dict(data=4, model=1),
                                   dict(pod=2, data=16, model=1)], ids=str)
def test_param_sharding_per_leaf_matches_reference_spec(shape):
    ours, ref = _pair(shape)
    params = {"w": torch.zeros(8, 4), "v": torch.zeros(6),
              "e": torch.zeros(64, 32), "b": torch.zeros(64, 3, 32),
              "s": torch.zeros(())}
    axes = {"w": ("fsdp", "tp"), "v": ("fsdp",), "e": ("vocab", "fsdp"),
            "b": ("act_batch", None, "fsdp"), "s": ()}
    got = dist.param_sharding(axes, params, ours)
    for k, p in params.items():
        want = ref.spec(axes[k], tuple(p.shape))
        assert got[k] == ours.sharding(axes[k], tuple(p.shape))
        assert got[k] == _placements_of(tuple(want), tuple(shape)), k


def test_param_sharding_requires_a_context():
    dist.set_context(None)
    with pytest.raises(RuntimeError):
        dist.param_sharding({}, {})


def test_tensor_parallel_mesh_raises_not_implemented():
    """Under a "model" axis wider than 1 a family outside ``FAMILIES``
    raises ``NotImplementedError`` naming it; every ported family builds
    there (``tests/test_torch_tp_train.py``); a model built for another
    "model" width raises ``ValueError``."""
    ctx = dist.DistContext(fake_mesh(data=2, model=2))
    assert ctx.spec(("fsdp", "tp"), (8, 8)) == ("data", "model")
    assert ctx.sharding(("fsdp", "tp"), (8, 8)) == [Shard(0), Shard(1)]
    assert dist.param_sharding({"w": (None,)}, {"w": torch.zeros(4)},
                               ctx) == {"w": [Replicate(), Replicate()]}
    model = Model(reduced(get_config("qwen3-4b")), device="cpu")
    batch = SyntheticLM(DataConfig(512, 8, 2)).batch_at(0)
    with dist.use_mesh(fake_mesh(data=1, model=16)):
        cfg = dataclasses.replace(reduced(get_config("qwen3-4b")),
                                  family="retnet")
        with pytest.raises(NotImplementedError, match="retnet"):
            Model(cfg, device="cpu")
        with pytest.raises(ValueError, match="build the model under"):
            model.train_loss(batch)


def test_use_mesh_restores_prior_context_on_exception():
    dist.set_context(None)
    mesh = fake_mesh(data=1, model=1)
    outer = dist.DistContext(mesh)
    dist.set_context(outer)
    try:
        with pytest.raises(RuntimeError):
            with dist.use_mesh(mesh):
                assert dist.current() is not outer
                raise RuntimeError("boom")
        assert dist.current() is outer
        with dist.use_mesh(mesh) as inner:
            assert dist.current() is inner
        assert dist.current() is outer
    finally:
        dist.set_context(None)


def test_rules_override_scoped_to_context():
    mesh = fake_mesh(data=1, model=1)
    rules = dict(dist.DEFAULT_RULES)
    rules["act_seq"] = ("model",)
    with dist.use_mesh(mesh, rules) as ctx:
        assert ctx.mesh_axes("act_seq") == ("model",)
    with dist.use_mesh(mesh) as ctx:
        assert ctx.mesh_axes("act_seq") == ()
    assert dist.current() is None


def test_constraint_and_gather_fsdp_without_context():
    dist.set_context(None)
    x = torch.ones(4, 4)
    assert dist.constraint(x, "act_batch", None) is x
    params = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(8)}
    axes = {"w": ("fsdp", "tp"), "b": ("fsdp",)}
    assert dist.gather_fsdp(params, axes) is params
    # inside a context a plain tensor is this rank's local shard: as is
    with dist.use_mesh(fake_mesh(data=4, model=1)):
        assert dist.constraint(x, "act_batch", None) is x
        assert dist.gather_fsdp(params, axes)["w"] is params["w"]


def _strip_layer(tree):
    """The reference's axes tree as ``{port parameter name: axes}``: its
    leading "layer" axis stripped, ``layers`` unstacked."""
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = val
    walk({k: v for k, v in tree.items() if k != "layers"}, "")
    return out, tree.get("layers", {})


@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3-mini-3.8b", "rwkv6-7b"])
def test_param_axes_match_reference(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    ref, layers = _strip_layer(JaxModel(jcfg).param_axes())
    model = Model(reduced(get_config(arch)), device="cpu")
    got = model.param_axes()
    layer_axes, _ = _strip_layer(layers)
    for i in range(jcfg.num_layers):
        for key, ax in layer_axes.items():
            assert ax[0] == "layer"
            ref[f"layers.{i}.{key}"] = ax[1:]
    assert got == ref
    assert set(got) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("n", [1, 7, 16, 64])
def test_topology_from_dist_matches_reference(shape, n):
    ours, ref = _pair(shape)
    np.testing.assert_array_equal(Topology.from_dist(ours, n).stage_of,
                                  JaxTopology.from_dist(ref, n).stage_of)


def test_tiered_dp_size_reads_unmapped_batch_name_as_reference(tmp_path):
    """Pins the reference's ``ctx.axis_size("batch")``
    (``src/repro/train/checkpoint.py:226``): no rule is named "batch" (the
    batch rule is "act_batch"), so the DP width is 1 under every mesh and
    the peer replica is the node itself."""
    for shape in MESHES:
        mesh = fake_mesh(**shape)
        with dist.use_mesh(mesh):
            ours = TieredCheckpointManager(str(tmp_path / "ours"),
                                           node_id=5)
        with jax_dist.use_mesh(mesh):
            ref = JaxTieredCheckpointManager(str(tmp_path / "ref"),
                                             node_id=5)
        assert ours.dp_size == ref.dp_size == 1
        assert ours.peer_rank == ref.peer_rank
    assert TieredCheckpointManager(str(tmp_path / "w"), node_id=3,
                                   dp_size=4).peer_rank == \
        JaxTieredCheckpointManager(str(tmp_path / "w2"), node_id=3,
                                   dp_size=4).peer_rank


@pytest.fixture
def one_rank_group(tmp_path):
    tdist.init_process_group("gloo", store=tdist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def test_meshes_need_a_group_of_their_size():
    assert not tdist.is_initialized()
    with pytest.raises(RuntimeError):
        launch_mesh.make_cpu_mesh()


def test_decode_matches_unsharded(one_rank_group):
    with pytest.raises(ValueError):
        launch_mesh.make_production_mesh(device="cpu")
    jcfg = jax_reduced(jax_get_config("qwen3-4b"))
    params, _ = JaxModel(jcfg).init_params(jax.random.key(2))
    model = model_params(jax.tree.map(np.asarray, params),
                         reduced(get_config("qwen3-4b")),
                         policy=Policy(), device="cpu")
    tok = np.asarray([3, 5], np.int32)
    plain, _ = model.decode_step(tok, model.init_cache(2, 32))
    mesh = launch_mesh.make_cpu_mesh()
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
        {"data": 1, "model": 1}
    with dist.use_mesh(mesh):
        sharded, _ = model.decode_step(tok, model.init_cache(2, 32))
    np.testing.assert_array_equal(plain.float().numpy(),
                                  sharded.float().numpy())


def _two_steps(arch, dtype, microbatch):
    model = Model(reduced(get_config(arch)), Policy(compute_dtype=dtype),
                  device="cpu", seed=0, remat="full")
    data = SyntheticLM(DataConfig(model.cfg.vocab_size, 64, 2))
    tr = Trainer(model, data, TrainConfig(
        steps=2, ckpt_interval=100, microbatch=microbatch,
        opt=AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=12)))
    hist = tr.run()["history"]
    full = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in tr.params.items()}
    for m in ("mu", "nu"):
        full.update({f"{m}/{k}": v.full_tensor()
                     if hasattr(v, "full_tensor") else v
                     for k, v in tr.opt_state[m].items()})
    return [(h["loss"], h["grad_norm"]) for h in hist], full


@pytest.mark.parametrize("arch,dtype,microbatch", [
    ("qwen3-4b", torch.bfloat16, 0), ("rwkv6-7b", torch.bfloat16, 0),
    ("qwen3-4b", torch.float32, 1)])
def test_one_rank_mesh_step_is_the_unsharded_step(one_rank_group, arch,
                                                  dtype, microbatch):
    plain = _two_steps(arch, dtype, microbatch)
    with dist.use_mesh(launch_mesh.make_cpu_mesh()):
        sharded = _two_steps(arch, dtype, microbatch)
    assert sharded[0] == plain[0]
    assert sorted(sharded[1]) == sorted(plain[1])
    for k, v in plain[1].items():
        assert torch.equal(sharded[1][k], v), k


def test_released_weights_raise_until_loaded_and_hooks_go(one_rank_group):
    def trained(mesh):
        model = Model(reduced(get_config("qwen3-4b")),
                      Policy(compute_dtype=torch.float32), device="cpu",
                      seed=0, remat="full")
        data = SyntheticLM(DataConfig(model.cfg.vocab_size, 32, 2))
        cfg = TrainConfig(steps=1, ckpt_interval=100,
                          opt=AdamWConfig(peak_lr=3e-4, warmup_steps=2,
                                          total_steps=12))
        if mesh is None:
            tr = Trainer(model, data, cfg)
        else:
            with dist.use_mesh(mesh):
                tr = Trainer(model, data, cfg)
        tr.run()
        return model, tr

    tok = np.arange(12, dtype=np.int32).reshape(2, 6)
    plain, plain_tr = trained(None)
    load_working(plain, plain_tr.params)
    want, _ = plain.prefill(tok)
    model, tr = trained(launch_mesh.make_cpu_mesh())
    assert all(p.numel() == 0 for p in model.parameters())
    for fn in (lambda: model.prefill(tok), lambda: master_params(model),
               lambda: model.decode_step(tok[:, 0], model.init_cache(2, 8))):
        with pytest.raises(RuntimeError, match="released"):
            fn()
    assert all(p._post_accumulate_grad_hooks for p in model.parameters())
    load_working(model, tr.params)
    got, _ = model.prefill(tok)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    del tr
    gc.collect()
    assert not any(p._post_accumulate_grad_hooks
                   for p in model.parameters())
